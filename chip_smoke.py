#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one JSON line:

1. device     — require CUDA, print the card's name and power limit, turn
                TF32 off;
2. build      — compile the CUDA kernels from
                ``src/repro_torch/kernels/csrc``;
3. kernels    — every kernel of the serving paths against its plain
                version, at the paths' shapes plus ragged, int8,
                fp32/fp16, masking and rounding-tie cases, with the
                reference test suite's tolerances (K3 bit for bit); K1
                at every distinct call of the eight served models (recorded
                from one prefill and one decode step at cut depth) at the
                prefill and decode row counts (Whisper's, internvl2-1b's
                and gemma2-27b's at their own served rows), and K4 at
                OLMoE's served capacities (C = 144, 64, 8, with and
                without the rows of a seeded routing), K2 at the
                attention paths' shapes (gemma2-2b's local and global
                layers with its softcap 50 at head_dim 256; Whisper's
                encoder and cross-attention over 1500 frames,
                internvl2-1b's group of 7, gemma2-27b's local and global
                layers), ragged, masked, softcapped and on the transposed
                views the models pass, each query row against its own
                scale (``row_rel_err``), each case on the tile that
                serves it (``launches_by_tile``); K1's backward (its
                autograd op's) at the training GLU projection, dA and
                dB row by row against autograd of the plain version; K1's,
                K4's, K2's and K6's tensor-core tiles once more each from a
                fresh ``threading.Thread`` that never set its device;
4. parity     — yi-6b at full width, 4 layers, fp32: prefill and 4 decode
                steps through the kernels against the plain torch route;
                parity-bf16 the same in bf16, which takes K1's
                tensor-core and decode tiles and K2's tensor-core tile
                through the model, and reports how far each route lies
                from the torch route with P rounded to bf16 in its
                prefill attention, as that tile rounds it;
5. moe-parity — the same for olmoe-1b-7b, with the count of (token,
                layer) expert choices that differ between the routes;
                moe-parity-bf16 the same in bf16, through K1's and K4's
                tensor-core and decode tiles;
6. serve      — yi-6b at full width and depth, bf16, seeded random
                weights: 8 requests through ``ServingEngine`` with launch
                counts, K1's and K2's by tile against the counts reckoned
                from the traffic;
7. moe-serve  — the same traffic through olmoe-1b-7b at full width and
                depth (the grouped-matmul kernel on every expert MLP),
                K4's launches by tile against the counts reckoned from
                the traffic;
8. kernels-recurrent — the RG-LRU scan and the chunked RWKV-6 WKV
                against their plain versions at the serving paths'
                shapes, with initial states, ragged lengths, carried
                state and the decay limits (the scan bit for bit); the
                WKV in bf16 and fp16 on its tensor-core tile (chunks 32
                and 64, the model's transposed views; output also row by
                row, bit-identical reruns) and in fp32 on its SIMT tile;
                flash attention at head_dim 256 (MQA 10/1, causal,
                window);
9. griffin-parity, rwkv-parity — the parity of phases 4-5 for
                recurrentgemma-2b (6 layers: two triples) and rwkv6-7b
                (4 layers);
10. griffin-serve, rwkv-serve — the traffic of phase 6 through
                recurrentgemma-2b (RG-LRU kernel on every recurrent block)
                and rwkv6-7b (WKV kernel on every time-mix block, its
                launches by tile against the count reckoned) at full
                width and depth;
11. exec       — yi-6b's serving step at full width as the TaskGraph the
                DES prices, lowered and run through the backend registry:
                ``backend.get("kernel")`` runs the int8 prefill (4 x 221
                tokens) and decode (4 tokens) steps at 64 x 64 tiles, one
                K1 launch per matrix tile (7,728 simt, 552 decode), every
                GEMM bit for bit against one ``cute_matmul`` on each
                route; ``get("kernel", granularity="panel")`` one bf16
                gate-up GEMM with a fused GLU (4,816 launches on K1's
                tensor-core tile) within 2e-2; ``get("desim")`` the decode
                step again, its numbers equal to the kernel backend's,
                its cycles simulated cycles of the paper's CPU matrix
                unit; K1's launches by tile against the counts reckoned
                from the graphs; the card's wall time a ``run_graph``, the
                host's time a dispatch, the DES's host time and the
                metrics registry's ``backend_calls_total`` and
                ``backend_seconds`` p50;
12. profile, moe-profile, griffin-profile, rwkv-profile (and, after
    phase 15, gemma27-profile) — device time by
                kernel of one prefill and over a few decode steps of each
                served model (``torch.profiler``), K1's by tile, the
                device's idle share of a decode step, and for tied
                embeddings the time of the transposed copy the logits
                take; K1's host time a call on each tile (yi-6b);
                measurement only;
13. paged      — ``paged_flash_attention`` on a shuffled block table of
                16-token pages equal bit for bit to the contiguous
                ``flash_attention`` (yi-6b's and RecurrentGemma's prefill
                shapes on K2's tensor-core tile, yi-6b's in fp32 on its
                SIMT tile), ``paged_decode_attention`` to
                ``decode_attention`` at yi-6b's decode shape;
14. gemma-parity, gemma-serve — phase 4's parity and phase 6's traffic
                for gemma2-2b (softcaps 50 in K2 and 30 in K1's logits,
                head_dim 256, tied embeddings), K1's and K2's launches by
                tile against the counts reckoned from the traffic;
15. whisper-parity, whisper-serve, internvl-parity, internvl-serve,
    gemma27-parity, gemma27-serve — phase 4's parity (fp32: Whisper at
                full size, 4 + 4 layers; internvl2-1b 4 layers; gemma2-27b
                one (local, global) pair) with seeded stub-frontend
                inputs that differ by row, and phase 6's traffic at full
                size in bf16: Whisper's non-GLU GELU MLP and its K2 calls
                over 1500 audio frames (the encoder, and the
                cross-attention at prefill and at every decode step),
                internvl2-1b's QKV bias and GQA 14/2 on prompts of 256
                vision-prefix positions and the text, gemma2-27b (27.2 B
                parameters, 54.45 GB) with its 73,728-wide GLU and tied
                256,000-wide logits; K1's and K2's launches by tile
                against the counts reckoned from the traffic, peak memory
                over the initialisation and over the run;
16. plan       — a planning-only ``ServingEngine(cfg, None)`` on yi-6b at
                full width prices the launcher's traffic on ``desim``,
                ``analytical`` and ``desim-cluster`` under three policies,
                and the serve traffic on ``analytical`` under the three
                and on ``desim-cluster`` under full prefill, equal to the
                reference's recorded numbers (``REFERENCE``, from
                ``scripts/record_smoke_constants.py``); runs the
                launcher traffic's full-prefill schedule with operands
                through K1 on desim and desim-cluster (bit-exact against
                ``cute_matmul``, equal to each other, launches by tile as
                reckoned); then
                ``launch.serve --plan desim --metrics-out``;
17. tune       — the full-space autotune of the four platforms
                regenerating the shipped tuning caches byte for byte,
                ``measure_decode_regime`` equal to the reference's, and
                the launcher's traffic planned with ``tuned=True`` on 2
                units and run with operands through
                ``get_tuned("desim-cluster")``: K1 at the cache's panel
                granularity, bit-exact against ``cute_matmul``, launches
                by tile as reckoned, cycles the reference's;
18. online     — the online closed loop (Poisson arrivals, chunked
                prefill, a paged KV pool that evicts and refills) equal to
                the reference's, and ``launch.serve --qps``; host only;
19. w8a8       — yi-6b's MLP at full width through ``quantize_mlp`` and
                the W8A8 layers (row-quantiser kernel, int8 fused matmul)
                against the plain route and the float MLP;
20. train-parity — yi-6b at full width, 2 layers, fp32: one
                ``make_train_step`` and one ``value_and_grad`` through the
                kernel route (K1 and its autograd Function) against the
                torch route: loss within 1e-5 relative, every gradient
                leaf within 1e-4 of its max, K1's launches as reckoned;
21. train      — yi-6b at full width cut to 8 layers, bf16 with fp32
                master weights, remat "full", through
                ``launch/train.py::train``: 6 AdamW steps of 2
                microbatches (2,048 rows a K1 call) with a checkpoint at
                step 4, then a run restored from step 4; a finite
                loss that falls, the resumed losses within 1e-3, K1's
                launches by tile as reckoned, peak memory within 15% of
                the reckoning, step ms and tokens/s;
22. dist       — distributed execution: ``DIST_RANKS`` ranks spawned on
                the card through ``launch.mesh.run_world`` (gloo where
                they share one card, NCCL where each has its own; the
                collectives gloo cannot take on CUDA tensors staged
                through the host and named on each line).  First, in this
                process, the references: OLMoE-1B-7B's serve traffic on
                one rank, all experts at once, and in bf16 also under an
                abstract (data 1, model 2) mesh (EP's two shards in turn,
                their partial outputs summed as the all-reduce sums
                them), and yi-6b's int8 serving step through
                ``backend.get("kernel")`` (phase exec holds it bit for
                bit against the torch route on these operands) and through ``get("sharded")`` as a loop of spans.
                Then on each rank: dist-ep-fp32 and dist-ep (OLMoE-1B-7B
                served expert-parallel on a (data 1, model 2) mesh, 4
                layers fp32 with tokens identical and prefill logits
                within 1e-5 of the one-rank run, then full depth bf16
                bit for bit against the shards in turn on one rank
                (against all experts at once, prefill logits, greedy
                tokens and expert choices reported), each rank holding 32
                of 64 experts, K1, K2 and K4 by tile as moe-serve's, peak
                memory against its reckoning); dist-cmm (collective
                matmul at yi-6b's logits shape in bf16, and int8 bit for
                bit, against the torch route); dist-pipe (GPipe, 2 stages
                x 4 tanh layers at width 4096 through K1, against the
                same layers on the torch route; ``kernels`` holds that K1
                call too); dist-sharded (the serving step through
                ``get("sharded", units=2)``, bit for bit against the
                kernel backend); dist-compress (``psum_compressed`` bit
                for bit against one rank's sum);
22b. dist-gspmd — OLMoE-1B-7B under the reference's GSPMD expert
                parallelism (``moe_shard_map=False``) on 4 ranks of (data
                2, model 2) spawned on the card: each rank keeps 32 of the
                64 experts with 512 of their 1,024 d_ff columns, gathers
                the tokens of the traffic's first batch (2 of its 4
                prompts a rank) and routes them whole at the whole batch's
                capacity; 4 layers fp32 under perf_iter's ar_gspmd_ep
                rules against one process off the mesh, 16 layers bf16
                with the dense leaves whole bit for bit against one
                process running the ranks' partials in turn; launches by
                tile, capacities, a decode step's collective bytes
                against the reckoning and the meta count, peak against
                its meta reckoning; the 4 fp32 layers again with the
                experts over data and model (16 a rank) against the same
                one process; one fp32 AdamW step of 2 layers under
                ar_gspmd_ep's rules against one process running the
                ranks' partials in turn and one off the mesh, its
                collective bytes against the reckoning and the meta
                count, peak against its meta reckoning (after phases
                dist-mesh, dist-seq and dist-rec, which the lines above
                and the README describe; dist-rec ends with reduced
                RWKV-6 on 8 ranks that split its heads);
23. dryrun     — the one-card dry run (``launch/dryrun.py``,
                ``core/hlo_cost.py``) held to the card: full-size yi-6b
                and OLMoE-1B-7B, one prefill and one decode step of the
                serve traffic's first batch, counted on meta, then on the
                card: launches by kernel, FLOPs and bytes equal; each
                step's roofline (H100 data-sheet peaks) beside its
                CUDA-event ms, the meta trace's ``temp_bytes`` beside
                the card's peak over the arguments; then (dryrun-eq2)
                the Hopper Eq. 2 tile beside K1's compiled tile.  Phase
                ``kernels`` counts one call each of K3, K5 and K6 on the
                card and on meta the same way;
23b. examples  — the six port-side examples (``examples/<name>_torch.py``)
                through their ``main`` on the card at the reference
                scripts' sizes: sim_timeline (the int8 PANEL graph, one K1
                launch a matrix tile, bit for bit against ``cute_matmul``
                on the torch route), cluster_scaling (``--units 4``,
                ``kernel`` and ``sharded`` for the three strategies bit
                for bit against the exact int32 product),
                serving_policies (host pricing), quickstart (the engine
                and the kernel route within 3e-2 of the torch route, the
                pipelined fp32 tiles within 1e-5 of the plain product);
                serve_batched (yi-6b, rwkv6-7b, recurrentgemma-2b
                reduced, fp32: the kernel route's greedy tokens equal the
                torch route's); the roofline report
                (``launch/roofline.py``) over yi-6b's one-card dry-run
                cells, written meanwhile in subprocesses; then train_lm
                alone at its default width (~100M parameters) to 110
                steps, then to 120 resuming from its step-100
                checkpoint, its first 3 losses against the torch route's;
                K1, K2, K5 and K6 launches by tile;
24. the ``kernels`` line: per kernel, its launches in the paths above, its
   time at the paths' largest shapes beside its plain version, a library
   call and its roofline bound; K1 at prefill (tensor-core tile), decode
   and logits (decode tile), its backward at the training GLU shape, K4
   at prefill (tensor-core tile), at decode
   with every row full and with a seeded routing's rows (decode tile), K2
   at head_dim 128 and 256 and at Whisper's encoder and cross-attention
   decode shapes (head_dim 64), and K6 at RWKV-6's prefill shape
   (tensor-core tiles, beside the SIMT tiles at the same shapes), timed
   from CUDA-graph
   replays; K1 on fp8 (e4m3fn, e5m2) at the prefill GLU shape (SIMT tile)
   and the decode one (decode tile) beside ``torch._scaled_mm`` where it
   takes the pair, K4 on fp8 at OLMoE's prefill and decode capacities,
   K2 on int8 at yi-6b's prefill shape (within 1, paged bit-identical); K3 and K5 from CUDA-graph replays over copies of their inputs
   that together exceed the L2 (``rotating``), with the older single-call
   timing beside it.

Each path's launch counts are set to 0 just before it runs and read just
after.  The last line is ``{"ok": true, "device": {...}}``.  Any failed
phase exits non-zero before it.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "yi-6b"
MOE_ARCH = "olmoe-1b-7b"
GRIFFIN_ARCH = "recurrentgemma-2b"
RWKV_ARCH = "rwkv6-7b"
N_REQUESTS, MAX_BATCH, CACHE_LEN, MAX_NEW = 8, 4, 512, 16
PROMPT_RANGE = (16, 256)            # inclusive, drawn with numpy seed 0
PARITY_LAYERS, PARITY_DECODE = 4, 4
GRIFFIN_PARITY_LAYERS = 6           # two (rec, rec, attn) triples
TOL_BF16, TOL_FP32 = 3e-2, 1e-5
# fp8 inputs (e4m3fn, e5m2) to K1 and K4, and the reference's tolerance
# for them (tests/test_matmul_kernel.py's 3e-2 of max |ref|)
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
TOL_FP8 = 3e-2
# K2 (flash attention) is held row by row (``row_rel_err``): each query
# row's max |out - ref| against that row's own max |ref|.  Row 0 of a
# causal call is one V row (|ref| near 4 for unit normals) while a row
# that averages a few hundred keys lies near 0.1-0.3, so one limit on the
# whole tensor's max |ref| would let a late row err by as much as its
# whole value.  A bf16 output carries 8 significant bits: one rounding
# step is 2^-7 = 7.8e-3 of the row's max at most, and the tensor-core
# tile's rounding of P to q's dtype adds about 1e-3.  On an H100 every
# bf16 case reads 7.69e-3 to 7.81e-3, fp16 9.4e-4, fp32 7.6e-7: the
# limit is 2.6 times the widest reading.
TOL_FLASH_BF16, TOL_FLASH_FP32 = 2e-2, 1e-3
GEMMA_ARCH = "gemma2-2b"
# this slice's served models: Whisper's encoder-decoder at full size (4 +
# 4 layers, 1500 audio frames), internvl2-1b (its 256 vision-prefix
# embeddings replace the first 256 of each prompt's positions, so its
# prompts are 256 placeholder tokens and the serve traffic's text) and
# gemma2-27b (27.2 B parameters, 54.45 GB in bf16 of the card's 80)
WHISPER_ARCH, INTERNVL_ARCH, GEMMA27_ARCH = ("whisper-tiny", "internvl2-1b",
                                             "gemma2-27b")
INTERNVL_PARITY_LAYERS = 4
GEMMA27_PARITY_LAYERS = 2           # one (local, global) pair
# the tune phase: the launcher's traffic planned with tuned=True on 2
# units under decode-priority (the tuning cache's "sched|u2|decode"
# bucket: granularity "panel" on the dispatch platform, shuttle), all
# requests arriving at 0 as the launcher's default --arrival-gap has it:
# with PLAN_ARRIVAL_GAP the reference's fair-share loader exhausts the
# DES's event budget on this schedule (after 138 s on a CPU host), and
# the port keeps that loader verbatim
TUNE_UNITS, TUNE_POLICY = 2, "decode-priority"
PAGED_BLOCK = 16                    # KV tokens a page
# planning (phase ``plan``), request i arriving at i x PLAN_ARRIVAL_GAP
# simulated cycles (1 ms at the paper's unit's 2 GHz); ``desim`` models
# one matrix unit, the cluster forms 4.  Two traffics: the launcher's
# (6 prompts of 4 + (i * 3) % 12 tokens), priced in all 9 cases and the
# one a schedule is executed for; and the serve phase's (``prompt_lengths``:
# 8 prompts of up to 221 tokens, prefill graphs of 7,728 tiles), priced
# in the cases of PLAN_SERVE_CASES.  The serve traffic's other 5 cases
# (desim, and desim-cluster's chunked-prefill and auto) are left out:
# on an H100 machine's host they took 130 s together, twice the 4 priced
# here (``scripts/time_plan_pricing.py``).
PLAN_PROMPTS = tuple(4 + (i * 3) % 12 for i in range(6))
PLAN_ARRIVAL_GAP = 2.0e6
PLAN_POLICIES = ("full-prefill", "chunked-prefill", "auto")
PLAN_CASES = tuple((backend_name, units, policy)
                   for backend_name, units in (("desim", 1),
                                               ("analytical", 4),
                                               ("desim-cluster", 4))
                   for policy in PLAN_POLICIES)
PLAN_SERVE_CASES = tuple(("analytical", 4, policy)
                         for policy in PLAN_POLICIES) + (
                             ("desim-cluster", 4, "full-prefill"),)
PLAN_LAUNCH_ARGV = ["--arch", ARCH, "--plan", "desim", "--arrival-gap",
                    str(PLAN_ARRIVAL_GAP)]
# the online closed loop (phase ``online``): 16 seeded Poisson arrivals at
# 16 requests/s of the unit's clock, chunked prefill, a hot KV pool of 10
# blocks of 16 tokens (one 128-token prompt and its 16 new tokens need 9),
# so blocks are evicted and refilled and some decode streams preempted
ONLINE_QPS, ONLINE_REQUESTS = 16.0, 16
ONLINE_ENGINE = dict(max_batch=MAX_BATCH, max_new_tokens=MAX_NEW,
                     policy="chunked-prefill", kv_hot_blocks=10)
ONLINE_LAUNCH_ARGV = ["--arch", ARCH, "--qps", "16", "--plan", "analytical"]
# The reference's numbers for phases ``plan`` and ``online``: the output of
#     PYTHONPATH=src python scripts/record_smoke_constants.py
# (the JAX package on the CPU at the arguments above: planning-only
# ``repro.serving.engine.ServingEngine(cfg, None)`` with
# ``evaluate_schedule`` / ``price_steps`` / ``decode_latency_stats``,
# ``repro.serving.online.OnlineServingEngine.run`` and the reference
# launcher ``repro.launch.serve.main``).  Cycles are simulated cycles of
# the paper's CPU matrix unit; the DES and the analytical form are
# deterministic Python, so the port must equal them exactly.
REFERENCE = {'launcher': {'online': ('[online:analytical] offered=16 req/s '
                                     'policy=full-prefill: 6/6 requests over '
                                     '11 admission epochs in _s wall',
                                     '  '
                                     '-----------------------------------------------',
                                     '  policy                   full-prefill',
                                     '  requests (completed)     6 (6)',
                                     '  admission epochs         11',
                                     '  TTFT p50 / p99           26090249 / '
                                     '31114295 cyc',
                                     '  ITL  p50 / p99           497792 / '
                                     '497792 cyc',
                                     '  makespan                 927524345 '
                                     'cyc',
                                     '  goodput                  13 req/s',
                                     '  preemptions / evictions  0 / 0',
                                     '  request spans            120 across 6 '
                                     'requests',
                                     '  '
                                     '-----------------------------------------------'),
                          'plan': ('[plan:desim] policy=full-prefill: 4 steps '
                                   '(2 prefill), graph slice 46621035 cyc '
                                   '(matrix_util=26.1%); full schedule '
                                   '9193355869 cyc = 4596677.9 us',
                                   '[plan:desim] TTFT (first token from '
                                   'arrival) p50=736407719 cyc p99=5306456057 '
                                   'cyc, inter-token p50=267238863 cyc, '
                                   'overlap=chained makespan=9199355869 cyc',
                                   '[plan:desim] per-resource utilization: '
                                   'mem_loader=87.1% dispatcher=0.1% '
                                   'scratchpad=87.1% pe_array=27.5% '
                                   'vector_unit=2.1%',
                                   '  '
                                   '----------------------------------------',
                                   '  policy / overlap  full-prefill / '
                                   'chained',
                                   '  steps (prefill)   4 (2)',
                                   '  TTFT p50 / p99    736407719 / '
                                   '5306456057 cyc',
                                   '  ITL  p50 / p99    267238863 / 267238863 '
                                   'cyc',
                                   '  makespan          9199355869 cyc',
                                   '  matrix util       26.1%',
                                   '  request spans     120 across 6 requests',
                                   '  '
                                   '----------------------------------------')},
             'online': {'kv': {'allocs': 98,
                               'evictions': 18,
                               'frees': 91,
                               'refill_bytes': 5767168.0,
                               'refills': 11},
                        'kv_digest': 'dd4342a8c59803515c5d191e178c376c64f2098ee4046b48d6e8dcec8f30a958',
                        'span_digest': '0d8d63a504f1db4b8d1f1e8db2a4add6b4405fa1c14fca76d8e8eb3930682fbc',
                        'span_violations': [],
                        'summary': {'completed': 16.0,
                                    'epochs': 30.0,
                                    'evictions': 0.0,
                                    'goodput_qps': 12.177974651374434,
                                    'itl_p50': 497794.04257273674,
                                    'itl_p99': 547484.394203186,
                                    'makespan': 2627694745.315339,
                                    'preemptions': 2.0,
                                    'ttft_p50': 25961774.564350605,
                                    'ttft_p99': 61493857.24632788}},
             'plan': {'analytical/auto': {'graph_cycles': 18671860.86956521,
                                          'policy': 'decode-priority',
                                          'stats': {'decode_p50': 187091199.99999997,
                                                    'decode_p99': 327077982.6086956,
                                                    'decode_tokens': 96.0,
                                                    'itl_p50': 68870678.2608695,
                                                    'itl_p99': 145986782.60869566,
                                                    'makespan': 1364015443.4782608,
                                                    'ttft_p50': 187091199.99999997,
                                                    'ttft_p99': 327077982.6086956},
                                          'step_cycles': [116281878.26086955,
                                                          66809321.73913042,
                                                          77116104.34782608,
                                                          1033060173.9130435,
                                                          64747965.217391305],
                                          'steps': 5,
                                          'units': 4},
                      'analytical/chunked-prefill': {'graph_cycles': 16829495.652173914,
                                                     'policy': 'chunked-prefill',
                                                     'stats': {'decode_p50': 201520695.65217388,
                                                               'decode_p99': 264391373.91304344,
                                                               'decode_tokens': 96.0,
                                                               'itl_p50': 68870678.26086956,
                                                               'itl_p99': 68870678.26086974,
                                                               'makespan': 1301328834.7826087,
                                                               'ttft_p50': 201520695.65217388,
                                                               'ttft_p99': 264391373.91304344},
                                                     'step_cycles': [116281878.26086955,
                                                                     81238817.39130434,
                                                                     1033060173.9130435,
                                                                     64747965.217391305],
                                                     'steps': 4,
                                                     'units': 4},
                      'analytical/full-prefill': {'graph_cycles': 16490852.173913036,
                                                  'policy': 'full-prefill',
                                                  'stats': {'decode_p50': 187091199.99999997,
                                                            'decode_p99': 1325095095.6521735,
                                                            'decode_tokens': 96.0,
                                                            'itl_p50': 66809321.73913038,
                                                            'itl_p99': 66809321.739130616,
                                                            'makespan': 2304314573.913043,
                                                            'ttft_p50': 187091199.99999997,
                                                            'ttft_p99': 1325095095.6521735},
                                                  'step_cycles': [116281878.26086955,
                                                                  1068949147.8260868,
                                                                  77116104.34782608,
                                                                  1035967443.4782609],
                                                  'steps': 4,
                                                  'units': 4},
                      'desim-cluster/auto': {'graph_cycles': 18683862.173910834,
                                             'policy': 'decode-priority',
                                             'stats': {'decode_p50': 187390766.3768052,
                                                       'decode_p99': 327502868.40578103,
                                                       'decode_tokens': 96.0,
                                                       'itl_p50': 68911986.08694983,
                                                       'itl_p99': 146112102.02897584,
                                                       'makespan': 1365038594.782495,
                                                       'ttft_p50': 187390766.3768052,
                                                       'ttft_p99': 327502868.40578103},
                                             'step_cycles': [116559772.75361027,
                                                             66830993.62319492,
                                                             77200115.94202603,
                                                             1033679791.3042476,
                                                             64767921.159416094],
                                             'steps': 5,
                                             'units': 4},
                      'desim-cluster/chunked-prefill': {'graph_cycles': 16834102.753620133,
                                                        'policy': 'chunked-prefill',
                                                        'stats': {'decode_p50': 201903953.62318194,
                                                                  'decode_p99': 264815939.71013176,
                                                                  'decode_tokens': 96.0,
                                                                  'itl_p50': 68911986.08694983,
                                                                  'itl_p99': 68911986.08694994,
                                                                  'makespan': 1302351666.0868459,
                                                                  'ttft_p50': 201903953.62318194,
                                                                  'ttft_p99': 264815939.71013176},
                                                        'step_cycles': [116559772.75361027,
                                                                        81344180.86957166,
                                                                        1033679791.3042476,
                                                                        64767921.159416094],
                                                        'steps': 4,
                                                        'units': 4},
                      'desim-cluster/full-prefill': {'graph_cycles': 16501712.6086937,
                                                     'policy': 'full-prefill',
                                                     'stats': {'decode_p50': 187390766.3768052,
                                                               'decode_p99': 1325823707.8261714,
                                                               'decode_tokens': 96.0,
                                                               'itl_p50': 66830993.62319493,
                                                               'itl_p99': 66830993.62319499,
                                                               'makespan': 2305342525.217413,
                                                               'ttft_p50': 187390766.3768052,
                                                               'ttft_p99': 1325823707.8261714},
                                                     'step_cycles': [116559772.75361027,
                                                                     1069295897.9711187,
                                                                     77200115.94202603,
                                                                     1036286738.5506575],
                                                     'steps': 4,
                                                     'units': 4},
                      'desim/auto': {'graph_cycles': 55229938.46393584,
                                     'policy': 'decode-priority',
                                     'stats': {'decode_p50': 736407718.95678,
                                               'decode_p99': 1314364710.0290887,
                                               'decode_tokens': 96.0,
                                               'itl_p50': 275484916.86953115,
                                               'itl_p99': 583956991.0723088,
                                               'makespan': 5438146867.014209,
                                               'ttft_p50': 736407718.95678,
                                               'ttft_p99': 1314364710.0290887},
                                     'step_cycles': [465168856.1161677,
                                                     267238862.84061223,
                                                     308472074.2027776,
                                                     4132273753.0429664,
                                                     258993320.81168464],
                                     'steps': 5,
                                     'units': 1},
                      'desim/chunked-prefill': {'graph_cycles': 47394174.78285144,
                                                'policy': 'chunked-prefill',
                                                'stats': {'decode_p50': 794135355.3623122,
                                                          'decode_p99': 1063620272.2318432,
                                                          'decode_tokens': 96.0,
                                                          'itl_p50': 275484916.86953115,
                                                          'itl_p99': 275484916.86953163,
                                                          'makespan': 5187402429.216963,
                                                          'ttft_p50': 794135355.3623122,
                                                          'ttft_p99': 1063620272.2318432},
                                                'step_cycles': [465168856.1161677,
                                                                324966499.2461445,
                                                                4132273753.0429664,
                                                                258993320.81168464],
                                                'steps': 4,
                                                'units': 1},
                      'desim/full-prefill': {'graph_cycles': 46621034.81168474,
                                             'policy': 'full-prefill',
                                             'stats': {'decode_p50': 736407718.95678,
                                                       'decode_p99': 5306456056.580426,
                                                       'decode_tokens': 96.0,
                                                       'itl_p50': 267238862.84061217,
                                                       'itl_p99': 267238862.8406124,
                                                       'makespan': 9199355868.755695,
                                                       'ttft_p50': 736407718.95678,
                                                       'ttft_p99': 5306456056.580426},
                                             'step_cycles': [465168856.1161677,
                                                             4275821805.4497957,
                                                             308472074.2027776,
                                                             4143893132.986954],
                                             'steps': 4,
                                             'units': 1}},
             'plan_serve': {'analytical/auto': {'graph_cycles': 99774747.8260869,
                                                'policy': 'decode-priority',
                                                'stats': {'decode_p50': 1861541426.0869567,
                                                          'decode_p99': 2738446608.695652,
                                                          'decode_tokens': 128.0,
                                                          'itl_p50': 70932034.78260851,
                                                          'itl_p99': 581409391.3043478,
                                                          'makespan': 3802181704.3478265,
                                                          'ttft_p50': 1861541426.0869567,
                                                          'ttft_p99': 2738446608.695652},
                                                'step_cycles': [514600069.56521744,
                                                                514600069.56521744,
                                                                514600069.56521744,
                                                                244931895.6521739,
                                                                66809321.73913042,
                                                                514600069.56521744,
                                                                66809321.73913042,
                                                                232563756.52173913,
                                                                993048486.9565219,
                                                                133618643.47826084],
                                                'steps': 10,
                                                'units': 4},
                            'analytical/chunked-prefill': {'graph_cycles': 97815791.30434771,
                                                           'policy': 'chunked-prefill',
                                                           'stats': {'decode_p50': 2376141495.652174,
                                                                     'decode_p99': 2675760000.0,
                                                                     'decode_tokens': 128.0,
                                                                     'itl_p50': 70932034.78260851,
                                                                     'itl_p99': 236686469.5652175,
                                                                     'makespan': 3739495095.6521745,
                                                                     'ttft_p50': 2376141495.652174,
                                                                     'ttft_p99': 2675760000.0},
                                                           'step_cycles': [514600069.56521744,
                                                                           514600069.56521744,
                                                                           514600069.56521744,
                                                                           244931895.6521739,
                                                                           581409391.3043479,
                                                                           236686469.5652174,
                                                                           993048486.9565219,
                                                                           133618643.47826084],
                                                           'steps': 8,
                                                           'units': 4},
                            'analytical/full-prefill': {'graph_cycles': 95412730.43478344,
                                                        'policy': 'full-prefill',
                                                        'stats': {'decode_p50': 1861541426.0869567,
                                                                  'decode_p99': 3669654400.0,
                                                                  'decode_tokens': 128.0,
                                                                  'itl_p50': 66809321.7391305,
                                                                  'itl_p99': 66809321.739130974,
                                                                  'makespan': 4679794226.086956,
                                                                  'ttft_p50': 1861541426.0869567,
                                                                  'ttft_p99': 3669654400.0},
                                                        'step_cycles': [1788732104.3478262,
                                                                        1068949147.8260868,
                                                                        747163826.0869565,
                                                                        1068949147.8260868],
                                                        'steps': 4,
                                                        'units': 4},
                            'desim-cluster/full-prefill': {'graph_cycles': 95586914.8610836,
                                                           'policy': 'full-prefill',
                                                           'stats': {'decode_p50': 1865532933.036282,
                                                                     'decode_p99': 3675651615.935287,
                                                                     'decode_tokens': 128.0,
                                                                     'itl_p50': 66830993.623194695,
                                                                     'itl_p99': 66830993.62319565,
                                                                     'makespan': 4686116520.283211,
                                                                     'ttft_p50': 1865532933.036282,
                                                                     'ttft_p99': 3675651615.935287},
                                                           'step_cycles': [1792701939.4130871,
                                                                           1069295897.9711187,
                                                                           748822784.9278865,
                                                                           1069295897.9711187],
                                                           'steps': 4,
                                                           'units': 4}},
             'tune': {'regime': {'boom': {'fusion_speedup': 2.524830244234549,
                                          'speedup': 2.524830244234549,
                                          'tuned': 111566.80193236712,
                                          'tuned_speedup': 1.1432390671856747,
                                          'tuned_unfused': 281687.23577136605,
                                          'untuned': 127547.52657004831,
                                          'untuned_unfused': 281687.23577136605},
                                 'kunminghu': {'fusion_speedup': 2.50951003901761,
                                               'speedup': 2.50951003901761,
                                               'tuned': 112484.27053140095,
                                               'tuned_speedup': 1.1725287709577346,
                                               'tuned_unfused': 282280.4061301234,
                                               'untuned': 131891.04347826086,
                                               'untuned_unfused': 282280.4061301234},
                                 'rocket': {'fusion_speedup': 2.5261790994014754,
                                            'speedup': 2.5261790994014754,
                                            'tuned': 111510.82125603859,
                                            'tuned_speedup': 1.143666826381964,
                                            'tuned_unfused': 281696.30601409846,
                                            'untuned': 127531.2270531401,
                                            'untuned_unfused': 281696.30601409846},
                                 'shuttle': {'fusion_speedup': 2.5247726571701805,
                                             'speedup': 2.5247726571701805,
                                             'tuned': 111571.26570048308,
                                             'tuned_speedup': 1.143273084874761,
                                             'tuned_unfused': 281692.0809664489,
                                             'untuned': 127556.4251207729,
                                             'untuned_unfused': 281692.0809664489}},
                      'sched': {'bucket': 'sched|u2|decode',
                                'config': {'granularity': 'panel'},
                                'graph_cycles': 25493485.07246102,
                                'overlap': 'chained',
                                'policy': 'decode-priority',
                                'steps': 5,
                                'units': 2}}}

TOL_WKV_FP32 = 1e-4
TOL_PATH = 1e-4
# bf16 parity: both routes accumulate in fp32 and round each projection's
# output to bf16, so they differ by the rounding of sums taken in another
# order (an ulp of bf16, 2^-8 relative, on some elements), carried through
# the layers; greedy tokens are reported, not required, since a rounding
# can flip a near-tied argmax of random weights.  On an H100 the routes
# read 1.04e-2 to 1.14e-2 of max |logit| apart, and each 1.30e-2 to
# 1.58e-2 from the same weights in fp32: the limit is about 1.8 times the
# widest gap between the routes and above the bf16 rounding's own reach.
# OLMoE's torch route takes the kernel route's expert choices in bf16
# (``phase_parity``), so its gap is of the same kind.  K2's tensor-core
# tile adds one rounding the torch route does not make (P to bf16): it
# alone moves OLMoE's prefill logits by 1.73e-2, and the kernel route
# lies at most 1.52e-2 from a torch route that makes it too.
TOL_PATH_BF16 = 2e-2
TOL_W8A8_ROUTES, TOL_W8A8_FLOAT = 1e-5, 0.05
# training (phases train-parity and train): yi-6b at full width, 2 layers
# in fp32 for the routes' parity, 8 in bf16 for the launcher's run (1.91 B
# parameters: 26.7 GB of bf16 weights and fp32 master, mu and nu, 38.2 GB
# with the gradients; the full 32 layers, 97 GB, fit no one card).  The
# learning rate is 1e-3, not the launcher's default 3e-3: on an H100 at
# this width, with the launcher's one warmup step, 3e-3 drove the loss
# from 11.58 up to 13.67 at step 4 and 11.90 at step 6, and 3e-4 left it
# flat (11.58-11.60), while 1e-3 took it to 11.46 by step 6.  The phase
# runs 3e-3 too, on both matmul routes, to show that the rise is the
# optimiser's and not the kernel route's.  One checkpoint (--ckpt-every
# 4 of 6 steps): see ``phase_train``
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH = 2, (2, 256)
TRAIN_LAYERS = 8
TRAIN_ROWS = 2048                   # a microbatch's rows: 4 x 512 tokens
TRAIN_ARGV = ["--global-batch", "8", "--seq-len", "512", "--microbatches",
              "2", "--steps", "6", "--ckpt-every", "4", "--lr", "1e-3",
              "--log-every", "1"]
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-5, 1e-4
TOL_RESUME = 1e-3
# the kernel route's bf16 losses against the torch route's, step by step:
# on an H100 they lay at most 3.2e-4 apart over 6 steps at lr 1e-3 (bf16
# roundings in another order, and Adam's moves on near-zero gradients)
TOL_TRAIN_ROUTES = 1e-3
TRAIN_LR_WITNESS = 3e-3             # the launcher's default rate
TOL_TRAIN_MEMORY = 0.15
# training every family: train-parity at full width in fp32 at the
# smallest depth that holds every block kind (None: Whisper's full 4 + 4
# layers), one step a matmul route; phase train's runs through the
# launcher (Whisper through make_train_step: the launcher's stream has no
# audio frames) at full width in bf16, TRAIN_FAMILY_STEPS steps a route,
# at the largest depth whose reckoned peak stays well inside the card's
# 80 GB (about 20 B a parameter: bf16 weights, fp32 master, mu, nu and
# accumulator, one microbatch's bf16 gradients): OLMoE 4 of 16 layers
# (1.89 B parameters), RWKV-6 8 of 32 (2.29 B); RecurrentGemma 9 of 26,
# three (rec, rec, attn) triples (all 26 held 2.89 B, but its RG-LRU's
# per-step loop on the host took 75-94 s of the phase, cut for the
# script's 1,200 s)
TRAIN_PARITY_FAMILIES = ((MOE_ARCH, 2), (GRIFFIN_ARCH, 3), (RWKV_ARCH, 2),
                         (WHISPER_ARCH, None))
TRAIN_FAMILY_LAYERS = {MOE_ARCH: 4, GRIFFIN_ARCH: 9, RWKV_ARCH: 8,
                       WHISPER_ARCH: None}
TRAIN_FAMILY_STEPS = 4
# learning rates other than TRAIN_ARGV's 1e-3: on an H100, RWKV-6 at 8
# layers and 1e-3 rose on both matmul routes at the second update, from
# 11.62 to 11.88 and 11.87 (Adam's first updates move each weight by about
# lr, a tenth of the scale of RWKV-6's LoRA factors, normals x 0.01);
# at 1e-4 it fell at every step, 11.64 to 11.39
TRAIN_FAMILY_LR = {RWKV_ARCH: 1e-4}
# a leaf whose gradient lies further than TOL_TRAIN_GRAD from the torch
# route's is held instead against the step with exact products (the torch
# route with every product of ``linear`` taken in fp64, forward and
# backward, and rounded once: ``exact_products``): the kernel route no
# further from it than TOL_TRAIN_GRAD, or than the torch route is.  fp32
# rounding alone moves a step's gradients by the torch route's distance
# from it; where the step amplifies rounding (RWKV-6's, whose gradients
# two fp32 routes give up to 4.2e-4 of a leaf's max apart on an H100),
# that distance is the scale, with no limit of its own
# distributed execution (phase dist): ranks spawned on this machine's
# cards; the world's join timeout; the fp32 EP case's depth, held to 1e-5
# of max |logit| (sums in another order only); the pipeline's shape; a
# rank's peak memory against its reckoning (weights it holds + KV cache)
DIST_RANKS, DIST_TIMEOUT, DIST_SEED = 2, 300.0, 7
DIST_DIR = ROOT / "build" / "dist"
DIST_EP_FP32_LAYERS, TOL_DIST_EP_FP32 = 4, 1e-5
PIPE_LAYERS, PIPE_WIDTH, PIPE_MICRO, PIPE_ROWS = 4, 4096, 6, 256
TOL_DIST_MEMORY = 0.15
DIST_COMPRESS_SHAPES = {"norm": (4096,), "wo": (1024, 4096),
                        "wq": (4096, 4096)}
# training and serving on a mesh (phase dist-mesh): DIST_MESH_RANKS ranks
# (gloo sharing the one card, or NCCL with a card a rank); yi-6b's prefill
# and decode steps on (data 1, model 2) at DIST_TP_FP32_LAYERS in fp32
# (TOL_PATH) and at full depth in bf16 (TOL_TP_BF16); one fp32 AdamW
# step at DIST_TRAIN_FP32_LAYERS on (data 2, model 2) against one rank's
# (TOL_TRAIN_LOSS, TOL_TRAIN_GRAD), a batch of DIST_TRAIN_FP32_BATCH; the
# launcher on (data 2, model 2) at DIST_TRAIN_LAYERS in bf16 with
# DIST_TRAIN_ARGV, no checkpoint, its losses against one rank's run of
# the same flags (TOL_TRAIN_ROUTES), each rank's peak against its
# reckoning (TOL_TRAIN_MEMORY)
DIST_MESH_RANKS, DIST_MESH_TIMEOUT = 4, 600.0
DIST_TP_FP32_LAYERS, DIST_TP_DECODE = 4, 4
# dist-tp in bf16 at full depth is held to one rank's bf16 logits by
# bf16 rounding's own reach at that depth: at each of the 5 logits, the
# 2-norm of the TP logits' distance from one rank's is at most
# TOL_TP_BF16 times that of one rank's bf16 logits from its fp32 ones on
# the same tokens.  A row projection's fp32 sum of partials rounds as
# one rank's K1 does, in another order, which flips some roundings; a
# second rounding, or a wrong head, adds error of its own.  On an H100
# (scripts/tp_bf16_yardstick.py, seeds 7-9, 15 logits each) the ratio
# read 0.624-0.686 for the path as it is, 0.783-0.883 with the partials
# rounded to bf16 before the sum, and about 32 with one rank's two KV
# heads swapped; by max-norm the first two lie 2.7e-2-3.2e-2 and
# 3.3e-2-3.8e-2 of max |logit| from one rank, too close to hold apart
TOL_TP_BF16 = 0.73
# serving on a model axis that does not divide the KV heads (phase
# dist-seq): DIST_SEQ_RANKS ranks on (data 1, model DIST_SEQ_RANKS), gloo
# sharing the one card; yi-6b's 4 KV heads on 8, so each rank's cache
# holds every KV head at its CACHE_LEN / 8 positions (sequence-parallel
# decode attention); dist-tp's traffic, depths, weights and limits, held
# to the same one-rank runs, and a rank's peak against its meta
# reckoning within TOL_TRAIN_MEMORY
DIST_SEQ_RANKS, DIST_SEQ_TIMEOUT = 8, 600.0
# the recurrent families and Whisper on a mesh (phase dist-rec):
# DIST_REC_RANKS ranks, gloo sharing the one card.  Serving on (data 1,
# model DIST_REC_RANKS), the serve traffic's first batch and
# DIST_TP_DECODE steps: each family in fp32 at its DIST_REC_FP32_LAYERS
# (None: whole; Griffin's 6 are two (rec, rec, attn) triples, so the ring
# and the state both run), held to one rank within TOL_FP32 of max
# |logit| with identical greedy tokens and the gathered cache within
# TOL_FP32; Griffin and RWKV-6 at full depth in bf16 by dist-tp's
# yardstick, at each family's limit (TOL_TP_BF16_REC).  Training on
# (data 2, model 2): one fp32 AdamW step of each at
# DIST_REC_TRAIN_LAYERS on a batch of DIST_TRAIN_FP32_BATCH, the plain
# torch route (K5 and K6 have no backward), held to one rank's
# (TOL_TRAIN_LOSS, TOL_TRAIN_GRAD).  Each rank's serving peak against
# its meta reckoning (TOL_DIST_MEMORY)
DIST_REC_RANKS, DIST_REC_TIMEOUT = 4, 600.0
DIST_REC_FP32_LAYERS = {"recurrentgemma-2b": 6, "rwkv6-7b": 4,
                        "whisper-tiny": None}
DIST_REC_TRAIN_LAYERS = {"recurrentgemma-2b": 6, "rwkv6-7b": 2,
                         "whisper-tiny": None}
# dist-rec's bf16 yardstick a family (TOL_TP_BF16's ratio; that limit was
# set on yi-6b at 2 ranks).  On an H100 (scripts/tp_bf16_yardstick.py
# --arch ... --ranks 4, seeds 7-9, 15 logits each) Griffin's 26 layers
# read 0.735-0.789 for the path as it is, 0.959-1.028 with the partials
# rounded to bf16 before the sum and 1.01-4.09 with rank 1's q heads
# reversed; RWKV-6's 32 read 0.845-0.907, 0.999-1.071 and 18.6-19.6
# with rank 1's receptance heads reversed: each limit lies between the
# sound path and the partials rounded twice
TOL_TP_BF16_REC = {"recurrentgemma-2b": 0.87, "rwkv6-7b": 0.95}
# dist-rec's last part: RWKV-6 on a model axis that splits its heads.
# Reduced RWKV-6 (d 128, 4 heads of 32) on DIST_REC_SPLIT_RANKS ranks of
# (data 1, model 8), fp32: a rank's time-mix columns are half a head and
# its WKV state leaf the reference's key-channel share, (L, B, 4, 4, 32).
# The width is forced: at full width (64 heads) the form needs a model
# axis of 128, which no mesh one card can spawn reaches.  4 prompts of
# DIST_REC_SPLIT_PROMPT seeded tokens (which the 8 ranks divide, so that
# the seq rule shards the prefill's stream), a prefill and
# DIST_REC_SPLIT_DECODE decode steps, without and with SP_RULES, each
# held to one process (TOL_FP32 of max |logit|, greedy identical, the
# gathered cache within TOL_FP32 of each leaf's max); K6 once a layer at
# prefill on every head (the SIMT tile: head size 32), checked at that
# shape against its plain version (TOL_WKV_FP32)
DIST_REC_SPLIT_RANKS, DIST_REC_SPLIT_TIMEOUT = 8, 300.0
DIST_REC_SPLIT_PROMPT, DIST_REC_SPLIT_DECODE = 256, 2
# dist-gspmd: OLMoE-1B-7B served under the reference's GSPMD expert
# parallelism (moe_shard_map=False) on DIST_GSPMD_RANKS ranks of (data 2,
# model 2): each rank holds 32 of the 64 experts (its data block), each
# with 512 of its 1,024 d_ff columns (its model block), and routes the
# whole batch (the 4 prompts of the serve traffic's first batch, 2 a data
# rank) at the whole batch's capacity.  fp32 at DIST_GSPMD_FP32_LAYERS
# under perf_iter's ar_gspmd_ep rules as they are (GSPMD_RULES: the
# attention's heads, the vocabulary and the experts' d_ff over model)
# against one process off the mesh (TOL_FP32, greedy identical); bf16 at
# DIST_GSPMD_BF16_LAYERS under GSPMD_WHOLE_RULES (the same expert
# placement, the dense leaves whole on every rank) bit for bit against
# one process running every rank's partial in turn under an abstract
# mesh: the tensor
# parallel attention's sums of partials would differ from one process's
# in rounding, so only the whole dense leaves let one process hold the
# ranks' arithmetic to the bit
DIST_GSPMD_RANKS, DIST_GSPMD_TIMEOUT = 4, 600.0
DIST_GSPMD_MESH = (2, 2)
# the bf16 run's depth (once all 16, cut for the script's 1,200 s: it
# is held bit for bit, at any depth; at 2 layers the fp32 runs' peaks
# lay past TOL_DIST_MEMORY of their meta reckoning, fixed costs weighing
# more)
DIST_GSPMD_FP32_LAYERS, DIST_GSPMD_BF16_LAYERS = 4, 4
GSPMD_RULES = {"experts": "data", "mlp_expert": "model", "embed": None}
GSPMD_WHOLE_RULES = {"embed": None, "heads": None, "kv_heads": None,
                     "mlp": None, "vocab": None, "experts": "data",
                     "mlp_expert": "model"}
# dist-gspmd also serves the fp32 run's configuration under
# GSPMD_EVERY_RULES, the experts over data and model together (16 of 64
# a rank, its block of (data, model), data major; the dense leaves under
# the default rules), held to the same one process off the mesh; and it
# trains: one fp32 AdamW step of DIST_GSPMD_TRAIN_LAYERS (remat "full",
# the plain torch route, a batch of DIST_TRAIN_FP32_BATCH) under
# GSPMD_RULES, held to one process under an abstract (2, 2) mesh, the
# ranks' partials in turn, and off the mesh (TOL_TRAIN_LOSS,
# TOL_TRAIN_GRAD); its collective bytes by kind == the reckoning
# (``_gspmd_train_collectives``) == the meta count; a rank's peak within
# TOL_DIST_MEMORY of meta arguments + temp
GSPMD_EVERY_RULES = {"experts": ("data", "model")}
DIST_GSPMD_TRAIN_LAYERS = 2
# sequence parallelism for every family (phase dist-sp): DIST_SP_RANKS
# ranks, gloo sharing the one card, under the reference's {"seq":
# "model"} rules (SP_RULES).  Serving on (data 1, model DIST_SP_RANKS):
# 4 prompts of DIST_SP_PROMPT seeded tokens (after internvl2-1b's 256
# vision positions), a cache of DIST_SP_CACHE slots, DIST_TP_DECODE
# decode steps; each family in fp32 at its DIST_SP_FP32_LAYERS, held to
# one process off the mesh within TOL_FP32 of max |logit| with identical
# greedy tokens and the gathered cache within TOL_FP32, and OLMoE's GSPMD
# form on (data 2, model 2) under GSPMD_RULES and SP_RULES held to the
# same; each family in bf16 (DIST_SP_BF16_LAYERS) against the same mesh
# without the seq rule, bit for bit where the ranks' sums run in the same order
# (gloo: a reduce-scatter is the all-reduce of which each rank keeps its
# chunk, on the same tensor).  Training on (data 2, model 2): one fp32
# AdamW step of each at DIST_SP_TRAIN_LAYERS (Griffin one (rec, rec,
# attn) triple, every block kind: its per-step RG-LRU loop, traced three
# times a rank, holds the phase near its budget) on a batch of
# DIST_TRAIN_FP32_BATCH (internvl2-1b's tokens after its 256 vision
# positions), held to one process under an abstract mesh of the same
# shape (TOL_TRAIN_LOSS, TOL_TRAIN_GRAD)
DIST_SP_RANKS, DIST_SP_TIMEOUT = 4, 600.0
DIST_SP_PROMPT = 256
DIST_SP_CACHE = {"internvl2-1b": 640}           # 512 slots elsewhere
DIST_SP_FP32_LAYERS = {"recurrentgemma-2b": 6, "rwkv6-7b": 4,
                       "whisper-tiny": None, "olmoe-1b-7b": 4,
                       "internvl2-1b": 4}
# the bf16 runs' depths, cut for the script's 1,200 s (at full depth
# they took 56 s of the phase's 166 on an H100 machine's host): they are
# held bit for bit against the same mesh without the rule, at any depth
DIST_SP_BF16_LAYERS = {"recurrentgemma-2b": 3, "rwkv6-7b": 4,
                       "whisper-tiny": None, "olmoe-1b-7b": 2,
                       "internvl2-1b": 4}
DIST_SP_TRAIN_LAYERS = {"recurrentgemma-2b": 3, "rwkv6-7b": 2,
                        "whisper-tiny": None, "olmoe-1b-7b": 2,
                        "internvl2-1b": 2}
SP_RULES = {"seq": "model"}
DIST_TRAIN_FP32_LAYERS, DIST_TRAIN_FP32_BATCH = 2, (4, 256)
DIST_TRAIN_LAYERS = 4
DIST_TRAIN_ARGV = ["--global-batch", "8", "--seq-len", "512",
                   "--microbatches", "2", "--steps", "4", "--lr", "1e-3",
                   "--log-every", "1", "--mesh", "host", "--model-parallel",
                   "2"]
# the placements no experiment's rules give (phase dist-forms):
# DIST_FORMS_RANKS ranks, gloo sharing the one card, on (data 2, model
# 2), each run one rule dictionary of DIST_FORMS (a change of one key of
# the default rules) on a model at full width, fp32, cut to its depth
# there (yi-6b and OLMoE one layer: a run's fp32 weights, gathered over
# data through the host at every step, 2 to 5 GB a rank at 2 layers,
# took 23-56 s a run, and the script must end within 1,200 s):
# the serve traffic's first batch (4 prompts of 221 tokens, 2 rows a
# data rank, a 512-slot cache), a prefill and DIST_FORMS_DECODE decode
# steps (the last counted on the card and on meta), held to one process
# within TOL_FP32 of max |logit| with greedy tokens identical; one AdamW
# step on a batch of DIST_TRAIN_FP32_BATCH (no remat, the plain torch
# route, K1 for the projections) held to one process (TOL_TRAIN_LOSS,
# TOL_TRAIN_GRAD).  OLMoE's shard_map form routes each data slice at the
# slice's capacity, so its one process runs under an abstract (2, 2)
# mesh, as dist-sp's does.  A decode step's collective bytes by kind ==
# ``_forms_decode_collectives`` == the meta count, a train step's card
# == meta
DIST_FORMS_RANKS, DIST_FORMS_TIMEOUT = 4, 600.0
DIST_FORMS_MESH, DIST_FORMS_DECODE = (2, 2), 2
#: run -> (arch, layers, rules, config overrides)
DIST_FORMS = {
    "yi-heads-none": (ARCH, 1, {"heads": None}, {}),
    "yi-mlp-none": (ARCH, 1, {"mlp": None}, {}),
    "yi-embed-model": (ARCH, 1, {"embed": "model"}, {}),
    "yi-heads-data-model": (ARCH, 1, {"heads": ("data", "model")}, {}),
    "yi-vocab-data-model": (ARCH, 1, {"vocab": ("data", "model")}, {}),
    "olmoe-experts-every": (MOE_ARCH, 1, {"experts": ("data", "model")},
                            {"moe_shard_map": True}),
    "rwkv-heads-none": (RWKV_ARCH, 2, {"heads": None}, {}),
    "rwkv-embed-model": (RWKV_ARCH, 2, {"embed": "model"}, {}),
    "griffin-mlp-none": (GRIFFIN_ARCH, 3, {"mlp": None}, {}),
}
# the port-side examples (phase examples): each ``examples/<name>_torch.py``
# run through its ``main`` on the card at the reference script's sizes
# (cluster_scaling at --units 4); the roofline report over yi-6b's
# one-card dry-run cells, written by ``launch/dryrun.py`` in subprocesses
# on the host beside the examples; then train_lm at its default width to
# EXAMPLES_TRAIN_STEPS[0] steps, then again to [1], resuming from the
# checkpoint written at step 100, and its first EXAMPLES_TRAIN_ROUTE_STEPS
# steps again on the torch route (losses within TOL_TRAIN_LOSS)
EXAMPLES_UNITS = 4
EXAMPLES_TRAIN_STEPS = (110, 120)
EXAMPLES_TRAIN_ROUTE_STEPS = 3
EXAMPLES_DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
#: quickstart's engine against its kernel route (tests/test_matmul_kernel.py)
TOL_EXAMPLES_BF16 = 3e-2
#: sim_timeline's graph (int32 tiles, then the SiLU-GLU in tensor ops)
#: against the fused kernel's epilogue (expf in registers)
TOL_EXAMPLES_FP32 = 1e-6
PROFILE_STEPS, UNTRACED_STEPS = 4, 16
MAX_ROWS_DECODE = 8                 # K1's decode tile serves M <= 8
# the tiled kernels' tiles, each by substrings of its kernel names in a
# profiler trace
MM_TILE_TAGS = {"tc": ("tc_tile_kernel",),
                "decode": ("decode_tile_kernel", "decode_reduce_kernel"),
                "simt": ("gemm_tile_kernel",)}
TILE_TAGS = {"fused_matmul": MM_TILE_TAGS, "grouped_matmul": MM_TILE_TAGS,
             "flash_attention": {"tc": ("flash_attention_tc_kernel",),
                                 "simt": ("flash_attention_kernel",)},
             "rwkv6_wkv": {"tc": ("rwkv6_wkv_tc_kernel",),
                           "simt": ("rwkv6_wkv_kernel",)}}
# a substring of each kernel's name in a profiler trace
KERNEL_TAGS = {"fused_matmul": "FusedMatmul",
               "grouped_matmul": "GroupedMatmul",
               "flash_attention": "flash_attention_",
               "quantize_rowwise": "quantize_rowwise_",
               "rglru_scan": "rglru_scan_kernel",
               "rwkv6_wkv": "rwkv6_wkv_"}



class PhaseFailed(Exception):
    pass


_T0 = time.perf_counter()


#: a file the spawned ranks lock around each line they print, so that
#: two ranks' lines (longer than a pipe writes at once) do not interleave
_EMIT_LOCK: "Path | None" = None


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    if _EMIT_LOCK is None:
        print(json.dumps(obj), flush=True)
        return
    import fcntl
    with open(_EMIT_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        print(json.dumps(obj), flush=True)


def rel_err(out, ref):
    """(max |out - ref| / max |ref|, max |out - ref|) in float64."""
    o, r = out.double(), ref.double()
    diff = (o - r).abs().max().item() if o.numel() else 0.0
    scale = r.abs().max().item() if r.numel() else 0.0
    return diff / (scale + 1e-30), diff


def l2_dist(out, ref) -> float:
    """||out - ref||_2 in float64."""
    return float((out.double() - ref.double()).norm())


def row_rel_err(out, ref):
    """(max over rows of max |out - ref| / max |ref| along the last dim,
    max |out - ref|) in float64; a row whose ref is all 0 (a query that
    sees no key) is held to its absolute error."""
    o, r = out.double(), ref.double()
    if not o.numel():
        return 0.0, 0.0
    diff, scale = (o - r).abs().amax(-1), r.abs().amax(-1)
    rel = diff / torch.where(scale > 0, scale, 1.0)
    return rel.max().item(), diff.max().item()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def in_fresh_thread(fn):
    """``fn()`` on a new ``threading.Thread`` that never set its device;
    its result, or what it raised, raised here."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:          # re-raised on the caller
            box["err"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


# ---------------------------------------------------------------------------
# Phase 1: device.
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    from repro_torch.core.precision import disable_tf32
    disable_tf32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": [torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32]})
    require(torch.cuda.get_device_capability(0) == (9, 0),
            "the kernels are built for sm_90a (Hopper)")
    return line


# ---------------------------------------------------------------------------
# Phase 2: build.
# ---------------------------------------------------------------------------

def ptxas_report(text):
    """{kernel: "N registers, S bytes spill stores"} from nvcc's ``-Xptxas
    -v`` log; a template kernel is named by its mangled arguments, e.g.
    ``decode_tile_kernel<NS_11FusedMatmulE13__nv_bfloat16Li4ELb1>``."""
    out, name, spill = {}, None, "?"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            t = re.search(r"([a-z_]+_kernel)I(.+?)EEv", m.group(1))
            name = f"{t.group(1)}<{t.group(2)}>" if t else m.group(1)[-60:]
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} registers, {spill} bytes spill stores"
            name = None
    return out


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    for stem in libs:
        build.load(stem)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for stem, path in libs.items():
        log = Path(str(path) + ".log")
        if log.exists():
            ptxas[stem] = ptxas_report(log.read_text())
    emit({"phase": "build", "seconds": seconds,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "ptxas": ptxas})


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------

def prompt_lengths():
    rng = np.random.default_rng(0)
    return rng.integers(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, N_REQUESTS), rng


def serve_prompts():
    """The serve traffic's prompt lengths as ints."""
    return tuple(int(n) for n in prompt_lengths()[0])


def padded_lengths(lengths):
    return [int(max(lengths[i:i + MAX_BATCH]))
            for i in range(0, len(lengths), MAX_BATCH)]


def _rand(gen, shape, dtype, device="cuda"):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8, device=device)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def matmul_case(gen, m, k, n, dtype, *, glu=False, act="none", bias=None,
                scale_a=False, scale_b=False, residual=False, softcap=0.0,
                out_dtype=None):
    """Inputs and epilogue for one K1 case, all on the card."""
    from repro_torch.core.fusion import Epilogue, EpilogueOperands
    from repro_torch.core.task import BiasType
    a = _rand(gen, (m, k), dtype)
    # scale B like a weight so bf16 outputs stay O(1)
    b = _rand(gen, (k, n), dtype)
    if dtype.is_floating_point:
        b = (b.float() / k ** 0.5).to(dtype)
    n_out = n // 2 if glu else n
    ops = EpilogueOperands(
        bias=(None if bias is None else
              _rand(gen, (n,) if bias == "row" else (m, n), torch.float32)),
        scale_a=_rand(gen, (m,), torch.float32).abs() if scale_a else None,
        scale_b=_rand(gen, (n,), torch.float32).abs() if scale_b else None,
        residual=_rand(gen, (m, n_out), torch.float32) if residual else None)
    ep = Epilogue(bias_type={None: BiasType.ZERO, "row": BiasType.ROW,
                             "full": BiasType.FULL}[bias],
                  activation=act, glu=glu, softcap=softcap,
                  has_scale_a=scale_a, has_scale_b=scale_b,
                  has_residual=residual,
                  out_dtype=out_dtype or (torch.float32 if dtype in (
                      torch.int8,) + FP8 else dtype))
    return a, b, ep, ops


def run_matmul(a, b, ep, ops):
    from repro_torch.kernels.matmul.ops import fused_matmul
    return fused_matmul(a, b, epilogue=ep, operands=ops)


def plain_matmul(a, b, ep, ops):
    from repro_torch.kernels.matmul.matmul import fused_matmul_plain
    acc = torch.int32 if a.dtype == torch.int8 else torch.float32
    return fused_matmul_plain(a, b, ep, ops, acc)


def matmul_backward_case(gen, m, k, n, dtype, act):
    """K1's backward at a GLU projection: a (m, k) and the weight (k, 2,
    n/2), both requiring grad, and the output's gradient g (m, n/2)."""
    a, b, ep, _ = matmul_case(gen, m, k, n, dtype, glu=True, act=act)
    g = _rand(gen, (m, n // 2), dtype)
    return (a.requires_grad_(), b.reshape(k, 2, n // 2).requires_grad_(), g,
            ep)


def plain_matmul_backward(a, b, g, ep):
    """(dA, dB) by autograd of K1's plain version."""
    from repro_torch.kernels.matmul.ref import fused_matmul_ref
    return torch.autograd.grad(fused_matmul_ref(a, b, epilogue=ep), (a, b),
                               g)


def attention_case(gen, b, h, hkv, sq, sk, d, dtype, transposed=False):
    """q (b, h, sq, d), k and v (b, hkv, sk, d); ``transposed``: each is a
    (b, s, heads, d) tensor seen through ``transpose(1, 2)``; ``"q"``: q
    alone is (Whisper's cross-attention, whose K and V are cached)."""
    def make(s, n, view):
        if view:
            return _rand(gen, (b, s, n, d), dtype).transpose(1, 2)
        return _rand(gen, (b, n, s, d), dtype)
    return (make(sq, h, bool(transposed)), make(sk, hkv, transposed is True),
            make(sk, hkv, transposed is True))


def run_attention(q, k, v, **kw):
    from repro_torch.kernels.attention.ops import flash_attention
    return flash_attention(q, k, v, **kw)


def plain_attention(q, k, v, **kw):
    from repro_torch.kernels.attention.attention import flash_attention_plain
    return flash_attention_plain(q, k, v, **kw)


def grouped_case(gen, e, c, k, n, dtype, *, glu=False, act="none"):
    """Inputs and epilogue for one K4 case, all on the card."""
    from repro_torch.core.fusion import Epilogue
    x = _rand(gen, (e, c, k), dtype)
    w = _rand(gen, (e, k, n), dtype)
    if dtype.is_floating_point:
        w = (w.float() / k ** 0.5).to(dtype)
    ep = Epilogue(activation=act, glu=glu, out_dtype=(
        torch.int32 if dtype == torch.int8 else torch.float32
        if dtype in FP8 else dtype))
    return x, w, ep


def run_grouped(x, w, ep, **promises):
    from repro_torch.kernels.moe.ops import grouped_matmul
    return grouped_matmul(x, w, epilogue=ep, **promises)


def routed_rows(x, tokens, top_k, seed):
    """The rows of a seeded routing of ``tokens`` tokens, each to top_k
    distinct experts, as ``moe_apply_local`` makes them: expert e's rows
    from min(count, C) on are zeroed in ``x`` (E, C, K) in place.
    Returns the promises the layer would pass (``rows``, ``max_rows``,
    ``max_experts``)."""
    e, c, _ = x.shape
    rng = np.random.default_rng(seed)
    picks = np.stack([rng.choice(e, top_k, replace=False)
                      for _ in range(tokens)])
    counts = np.minimum(np.bincount(picks.ravel(), minlength=e), c)
    for i, n in enumerate(counts):
        x[i, n:] = 0
    return dict(rows=torch.tensor(counts, dtype=torch.int32, device="cuda"),
                max_rows=min(c, tokens), max_experts=min(e, tokens * top_k))


def plain_grouped(x, w, ep):
    from repro_torch.kernels.moe.grouped_matmul import grouped_matmul_plain
    acc = torch.int32 if x.dtype == torch.int8 else torch.float32
    return grouped_matmul_plain(x, w, ep, acc)


def run_quant(x):
    from repro_torch.kernels.quant.ops import quantize_rowwise
    return quantize_rowwise(x)


def plain_quant(x):
    from repro_torch.kernels.quant.quant import quantize_rowwise_plain
    return quantize_rowwise_plain(x)


def ties_rows(gen, m, k, dtype):
    """Rows with absmax 127, so x / scale is x and every n + .5 is an
    exact rounding tie; row 1 is all zeros."""
    x = torch.randint(-254, 255, (m, k), generator=gen, device="cuda") / 2.0
    x[:, 0] = 127.0
    x[1] = 0.0
    return x.to(dtype)


def stub_inputs(cfg, b, gen):
    """The stub frontends' inputs of a batch of ``b`` rows, seeded and
    different by row: Whisper's audio frame embeddings, InternVL's
    vision-prefix embeddings (none for the other models)."""
    out = {}
    if cfg.encdec is not None:
        out["audio_embeds"] = torch.randn(
            (b, cfg.encdec.n_audio_ctx, cfg.d_model), generator=gen,
            device="cuda")
    if cfg.vision_prefix:
        out["vision_embeds"] = torch.randn(
            (b, cfg.vision_prefix, cfg.d_model), generator=gen,
            device="cuda")
    return out


@contextlib.contextmanager
def recorded_k1_calls(key):
    """Within the block, ``key(a, b, ep, ops)`` of every K1 launch (the
    wrapper's 2-D call) goes into the dict yielded, once for each distinct
    key, in order of first launch."""
    from repro_torch.kernels.matmul import ops as mm_ops
    calls = {}
    inner = mm_ops.fused_matmul_cuda

    def recording(a, b, ep, ops):
        calls[key(a, b, ep, ops)] = None
        return inner(a, b, ep, ops)

    mm_ops.fused_matmul_cuda = recording
    try:
        yield calls
    finally:
        mm_ops.fused_matmul_cuda = inner


def served_k1_calls(arch, n_layers, prompt=None):
    """Every distinct K1 call that one prefill and one decode step of
    ``arch`` at full width, cut to ``n_layers`` layers, make in bf16, as
    (rows, k, n, glu, activation, softcap, bias, out dtype).  Without
    ``prompt`` the step runs at batch 1 on 16 tokens and ``rows`` is
    (4 x the longest serve prompt, the serve batch): the served row
    counts of the decoder-only models.  With ``prompt`` it runs at the
    serve batch on ``prompt`` tokens (the stub frontends' inputs
    included), and ``rows`` is each call's own row count."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.base import family_module
    cfg = get_config(arch).with_(n_layers=n_layers)
    mod = family_module(cfg)
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = mod.init(cfg, gen, "cuda")
    b, s = (1, 16) if prompt is None else (MAX_BATCH, prompt)

    def key(a, b_, ep, ops):
        return (None if prompt is None else a.shape[0], a.shape[1],
                b_.shape[1], ep.glu, ep.activation, ep.softcap,
                ep.bias_type.name.lower(), ep.out_dtype)

    with recorded_k1_calls(key) as calls:
        tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda")
        cache = mod.init_cache(cfg, b, s + 16, device="cuda")
        logits, cache = mod.prefill(
            cfg, params, {"tokens": tokens, **stub_inputs(cfg, b, gen)},
            cache)
        mod.decode_step(cfg, params, logits.argmax(-1)[:, None], cache, s)
        torch.cuda.synchronize()
    del params, cache
    torch.cuda.empty_cache()
    s_max = max(padded_lengths(prompt_lengths()[0]))
    return [((4 * s_max, MAX_BATCH) if rows is None else (rows,), *call)
            for rows, *call in calls]


def train_batch(cfg, b, s, device, seed=0, step=0):
    """A ``SyntheticLM`` batch of ``b`` x ``s`` tokens (the launcher's
    stream, its ``step``-th batch), with seeded ``audio_embeds`` (the stub
    frontend's frames, unit normals) for an encoder-decoder model."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, global_batch=b,
                                  seq_len=s), device=device)
    data.state.step = step
    batch = next(data)
    if cfg.encdec is not None:
        gen = torch.Generator(device=device).manual_seed(seed * 1000 + step)
        batch["audio_embeds"] = torch.randn(
            (b, cfg.encdec.n_audio_ctx, cfg.d_model), generator=gen,
            device=device)
    return batch


def train_k1_calls():
    """Every distinct K1 call of one bf16 train step of each trained
    family at full width, cut to one layer group (yi-6b and OLMoE one
    layer, RecurrentGemma one (rec, rec, attn) triple, RWKV-6 one layer,
    Whisper one encoder and one decoder layer), on one microbatch of
    ``phase_train`` (TRAIN_ROWS rows: TRAIN_ROWS / 512 sequences of 512
    tokens): the forward, remat's recompute, the backward's accumulator
    recomputes and the loss's fp32 logits, as (rows, k, n, glu,
    activation, softcap, bias, residual, operand dtype, out dtype)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.base import family_module
    from repro_torch.training import train_step as ts
    seq = 512

    def key(a, b, ep, ops):
        return (a.shape[0], a.shape[1], b.shape[1], ep.glu, ep.activation,
                ep.softcap, ep.bias_type.name.lower(), ep.has_residual,
                a.dtype, ep.out_dtype)

    cut = {ARCH: dict(n_layers=1), MOE_ARCH: dict(n_layers=1),
           GRIFFIN_ARCH: dict(n_layers=3), RWKV_ARCH: dict(n_layers=1)}
    cut[WHISPER_ARCH] = dict(n_layers=1, encdec=dataclasses.replace(
        get_config(WHISPER_ARCH).encdec, n_encoder_layers=1))
    with recorded_k1_calls(key) as calls:
        for arch, over in cut.items():
            cfg = get_config(arch).with_(backend="torch", **over)
            params = family_module(cfg).init(
                cfg, torch.Generator(device="cuda").manual_seed(9), "cuda")
            batch = train_batch(cfg, TRAIN_ROWS // seq, seq, "cuda")
            ts.value_and_grad(cfg, ts.TrainConfig(loss_chunk=seq), params,
                              batch)
            torch.cuda.synchronize()
            del params, batch
            torch.cuda.empty_cache()
    return list(calls)


def phase_kernels(cfg, moe_cfg, gemma_cfg, s_max, served, trained):
    """``served``: arch -> its distinct K1 calls (``served_k1_calls``);
    ``trained``: those of a train step (``train_k1_calls``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fusion import EpilogueOperands
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    gen = torch.Generator(device="cuda").manual_seed(1)
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    results = []

    def check_mm(name, tol, tile, **case):
        """One K1 case, which must run on ``tile``."""
        a, b, ep, ops = matmul_case(gen, **case)
        before = dict(fused_matmul.launches_by_tile)
        out = run_matmul(a, b, ep, ops)
        ran = [t for t, n in fused_matmul.launches_by_tile.items()
               if n != before[t]]
        ref = plain_matmul(a, b, ep, ops)
        torch.cuda.synchronize()
        rel, diff = rel_err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all())
              and ran == [tile])
        results.append({"kernel": "fused_matmul", "case": name, "tile": ran,
                        "rel": rel, "max_abs_err": diff, "tol": tol,
                        "ok": ok})

    bf16 = torch.bfloat16
    for m in (4 * s_max, MAX_BATCH):               # prefill, decode rows
        for tag, k, n, kw in (("wq", d, cfg.q_dim, {}),
                              ("wk", d, cfg.kv_dim, {}),
                              ("wi", d, 2 * ff, dict(glu=True, act="silu")),
                              ("wo", cfg.q_dim, d, {}),
                              ("mlp_wo", ff, d, {})):
            check_mm(f"{tag} m={m}", TOL_BF16,
                     "tc" if m > MAX_ROWS_DECODE else "decode", m=m, k=k,
                     n=n, dtype=bf16, **kw)
    check_mm("logits m=4 fp32-out", TOL_BF16, "decode", m=MAX_BATCH, k=d,
             n=vocab, dtype=bf16, out_dtype=torch.float32)
    check_mm("ragged 5x72x200 all-epilogue bf16", TOL_BF16, "decode", m=5,
             k=72, n=200, dtype=bf16, glu=True, act="gelu", bias="row",
             scale_a=True, scale_b=True, residual=True, softcap=30.0)
    check_mm("ragged 5x72x200 fp32", TOL_FP32, "decode", m=5, k=72, n=200,
             dtype=torch.float32, bias="full", act="tanh", residual=True)
    check_mm("fp32 130x257x300 relu2", TOL_FP32, "simt", m=130, k=257,
             n=300, dtype=torch.float32, act="relu2", bias="row")
    check_mm("fp16 200x512x384 glu", TOL_BF16, "tc", m=200, k=512, n=384,
             dtype=torch.float16, glu=True, act="gelu_tanh", scale_b=True)
    check_mm("int8 exact 64x4096x256", 0.0, "simt", m=64, k=4096, n=256,
             dtype=torch.int8, out_dtype=torch.int32)
    check_mm("int8 exact 3x100x70", 0.0, "decode", m=3, k=100, n=70,
             dtype=torch.int8, out_dtype=torch.int32)
    check_mm("int8 scale_a scale_b row-bias 37x200x300", TOL_FP32, "simt",
             m=37, k=200, n=300, dtype=torch.int8, bias="row", scale_a=True,
             scale_b=True, act="sigmoid")
    check_mm("tc ragged 70x1000x384 all-epilogue bf16", TOL_BF16, "tc", m=70,
             k=1000, n=384, dtype=bf16, act="gelu", bias="row",
             scale_a=True, scale_b=True, residual=True, softcap=30.0)
    # dist-pipe's layer: linear(x, W, tanh) on each microbatch
    check_mm(f"dist-pipe tanh {PIPE_ROWS}x{PIPE_WIDTH}x{PIPE_WIDTH} bf16",
             TOL_BF16, "tc", m=PIPE_ROWS, k=PIPE_WIDTH, n=PIPE_WIDTH,
             dtype=bf16, act="tanh")
    check_mm("bf16 K % 8 != 0: 70x100x128", TOL_BF16, "simt", m=70, k=100,
             n=128, dtype=bf16, act="silu")
    # every served model's K1 calls at its prefill and decode rows; the
    # logits (fp32 out) run only at the decode rows, as they are served
    for arch, calls in served.items():
        for rows, k, n, glu, act, softcap, bias, out_dt in calls:
            for m in rows:
                if out_dt == torch.float32 and m > MAX_ROWS_DECODE:
                    continue
                check_mm(f"{arch} ({m},{k})@({k},{n}){' GLU' * glu} {act}"
                         f"{' softcap' * bool(softcap)}"
                         f"{' bias' * (bias != 'zero')} -> {str(out_dt)[6:]}",
                         TOL_BF16, "tc" if m > MAX_ROWS_DECODE else "decode",
                         m=m, k=k, n=n, dtype=bf16, glu=glu, act=act,
                         softcap=softcap,
                         bias=None if bias == "zero" else bias,
                         out_dtype=out_dt)

    # every K1 call of a bf16 train step at its rows, all on the
    # tensor-core tile: the projections, the GLU backward's fp32
    # accumulator and the (2,048, d) x (d, vocab) fp32 logits
    for rows, k, n, glu, act, softcap, bias, res, dt, out_dt in trained:
        check_mm(f"train ({rows},{k})@({k},{n}){' GLU' * glu} {act}"
                 f"{' softcap' * bool(softcap)}{' bias' * (bias != 'zero')}"
                 f"{' residual' * res} {str(dt)[6:]} -> {str(out_dt)[6:]}",
                 TOL_BF16, "tc", m=rows, k=k, n=n, dtype=dt, glu=glu,
                 act=act, softcap=softcap,
                 bias=None if bias == "zero" else bias, residual=res,
                 out_dtype=out_dt)

    # K1's backward (its autograd op's) at the training GLU projection, 2,048
    # rows: dA and dB against autograd of the plain version, row by row
    # (``row_rel_err``); its one launch, the accumulator recompute, on the
    # tensor-core tile
    a, b, g, ep = matmul_backward_case(gen, TRAIN_ROWS, d, 2 * ff, bf16,
                                       "silu")
    out = run_matmul(a, b, ep, EpilogueOperands())
    before = dict(fused_matmul.launches_by_tile)
    grads = torch.autograd.grad(out, (a, b), g)
    ran = [t for t, n in fused_matmul.launches_by_tile.items()
           if n != before[t]]
    refs = plain_matmul_backward(a, b, g, ep)
    torch.cuda.synchronize()
    errs = [row_rel_err(x.reshape(x.shape[0], -1), r.reshape(r.shape[0], -1))
            for x, r in zip(grads, refs)]
    results.append({
        "kernel": "fused_matmul", "tile": ran,
        "case": f"backward: bf16 ({TRAIN_ROWS},{d})@({d},2,{ff}) GLU silu, "
                "dA and dB row by row",
        "rel": max(e[0] for e in errs), "rel_dA_dB": [e[0] for e in errs],
        "max_abs_err": max(e[1] for e in errs), "tol": TOL_BF16,
        "ok": (ran == ["tc"] and max(e[0] for e in errs) <= TOL_BF16
               and all(x.shape == r.shape and x.dtype == r.dtype
                       and bool(torch.isfinite(x).all())
                       for x, r in zip(grads, refs)))})
    del a, b, g, out, grads, refs

    def check_attn(name, tol, tile, shape, dtype, zero_rows=None,
                   transposed=False, **kw):
        """One K2 case, which must run on ``tile``; ``transposed``: q, k, v
        are (B, S, H, D) memory seen as (B, H, S, D), as the models'
        ``qkv_project`` passes them."""
        q, k, v = attention_case(gen, *shape, dtype, transposed=transposed)
        kw = dict(sm_scale=shape[-1] ** -0.5, window=0, softcap=0.0,
                  q_start=0) | kw
        before = dict(flash_attention.launches_by_tile)
        out = run_attention(q, k, v, **kw)
        ran = [t for t, n in flash_attention.launches_by_tile.items()
               if n != before[t]]
        ref = plain_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        same = out.dtype == ref.dtype and out.shape == ref.shape
        (rel, diff), (rel_all, _) = ((row_rel_err(out, ref), rel_err(out, ref))
                                     if same else ((None, None),) * 2)
        ok = (same and rel <= tol and ran == [tile]
              and bool(torch.isfinite(out.double()).all()))
        if zero_rows is not None:
            ok = ok and bool((out[:, :, zero_rows] == 0).all())
        results.append({"kernel": "flash_attention", "case": name,
                        "tile": ran, "rel": rel, "rel_of_max_ref": rel_all,
                        "max_abs_err": diff, "tol": tol, "ok": ok})

    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mh, mhkv = moe_cfg.n_heads, moe_cfg.n_kv_heads
    for s in (s_max, min(padded_lengths(prompt_lengths()[0]))):
        check_attn(f"yi-6b path b=4 {h}/{hkv} s={s} d={hd} bf16",
                   TOL_FLASH_BF16, "tc", (MAX_BATCH, h, hkv, s, s, hd), bf16,
                   causal=True)
    check_attn(f"yi-6b path b=4 s={s_max} transposed views",
               TOL_FLASH_BF16, "tc", (MAX_BATCH, h, hkv, s_max, s_max, hd),
               bf16, transposed=True, causal=True)
    check_attn(f"olmoe path b=4 {mh}/{mhkv} s={s_max} d={moe_cfg.head_dim} "
               "bf16 transposed views", TOL_FLASH_BF16, "tc",
               (MAX_BATCH, mh, mhkv, s_max, s_max, moe_cfg.head_dim), bf16,
               transposed=True, causal=True)
    # gemma2-2b's prefill: its local layers (window 4096) and global ones
    # (no window), both with the attention softcap
    gh, ghkv, ghd = gemma_cfg.n_heads, gemma_cfg.n_kv_heads, gemma_cfg.head_dim
    for window in (gemma_cfg.window, 0):
        check_attn(f"gemma2-2b path b=4 {gh}/{ghkv} s={s_max} d={ghd} "
                   f"softcap {gemma_cfg.attn_softcap:g} window {window} "
                   "bf16 transposed views", TOL_FLASH_BF16, "tc",
                   (MAX_BATCH, gh, ghkv, s_max, s_max, ghd), bf16,
                   transposed=True, causal=True, window=window,
                   softcap=gemma_cfg.attn_softcap,
                   sm_scale=gemma_cfg.sm_scale)
    # this slice's served attention: Whisper's non-causal encoder over
    # its 1500 frames and its cross-attention (q a transposed view, the
    # cached K/V contiguous) at prefill and at every decode step;
    # internvl2-1b's prefill over the vision prefix and the text (GQA 14/2,
    # group 7); gemma2-27b's local and global layers (GQA 32/16, softcap
    # 50, query scale 144^-0.5)
    w_cfg, iv_cfg, g27_cfg = (get_config(a) for a in (
        WHISPER_ARCH, INTERNVL_ARCH, GEMMA27_ARCH))
    wh, wd, ta = w_cfg.n_heads, w_cfg.head_dim, w_cfg.encdec.n_audio_ctx
    check_attn(f"whisper encoder b=4 {wh}/{wh} s={ta} d={wd} non-causal "
               "bf16 transposed views", TOL_FLASH_BF16, "tc",
               (MAX_BATCH, wh, wh, ta, ta, wd), bf16, transposed=True,
               causal=False)
    for sq in (s_max, 1):
        check_attn(f"whisper cross b=4 {wh}/{wh} Sq={sq} Sk={ta} d={wd} "
                   "bf16, q a transposed view", TOL_FLASH_BF16, "tc",
                   (MAX_BATCH, wh, wh, sq, ta, wd), bf16, transposed="q",
                   causal=False)
    s_iv = iv_cfg.vision_prefix + s_max
    check_attn(f"internvl2-1b path b=4 {iv_cfg.n_heads}/{iv_cfg.n_kv_heads} "
               f"s={s_iv} d={iv_cfg.head_dim} bf16 transposed views",
               TOL_FLASH_BF16, "tc", (MAX_BATCH, iv_cfg.n_heads,
                                      iv_cfg.n_kv_heads, s_iv, s_iv,
                                      iv_cfg.head_dim), bf16,
               transposed=True, causal=True)
    for window in (g27_cfg.window, 0):
        check_attn(f"gemma2-27b path b=4 {g27_cfg.n_heads}/"
                   f"{g27_cfg.n_kv_heads} s={s_max} d={g27_cfg.head_dim} "
                   f"softcap {g27_cfg.attn_softcap:g} window {window} "
                   "bf16 transposed views", TOL_FLASH_BF16, "tc",
                   (MAX_BATCH, g27_cfg.n_heads, g27_cfg.n_kv_heads, s_max,
                    s_max, g27_cfg.head_dim), bf16, transposed=True,
                   causal=True, window=window,
                   softcap=g27_cfg.attn_softcap, sm_scale=g27_cfg.sm_scale)
    for sq in (1, 63, 65, 300):
        check_attn(f"tc Sq=Sk={sq} d=128 GQA 4/2", TOL_FLASH_BF16, "tc",
                   (2, 4, 2, sq, sq, 128), bf16, causal=True)
    check_attn("tc Sq<Sk q_start=250 d=128", TOL_FLASH_BF16, "tc",
               (2, 4, 2, 50, 300, 128), bf16, causal=True, q_start=250)
    check_attn("bf16 non-causal ragged d=64", TOL_FLASH_BF16, "tc",
               (1, 4, 4, 70, 33, 64), bf16, causal=False)
    check_attn("fp16 non-causal ragged d=64", TOL_FLASH_BF16, "tc",
               (1, 4, 4, 70, 33, 64), torch.float16, causal=False)
    check_attn("tc softcap 50 d=128", TOL_FLASH_BF16, "tc",
               (2, 8, 2, 200, 200, 128), bf16, causal=True, softcap=50.0)
    check_attn("tc window 37 cuts key tiles, q_start=11 d=128",
               TOL_FLASH_BF16, "tc", (2, 4, 1, 250, 261, 128), bf16,
               causal=True, window=37, q_start=11)
    # queries at 100..119 with a window of 4 see none of the 40 keys
    check_attn("tc fully masked rows are 0 d=128 bf16", TOL_FLASH_BF16,
               "tc", (1, 4, 1, 20, 40, hd), bf16, zero_rows=slice(0, 20),
               causal=True, window=4, q_start=100)
    check_attn("fp32 window+softcap+q_start, Sq<Sk", TOL_FLASH_FP32, "simt",
               (2, 8, 2, 50, 300, hd), torch.float32, causal=True,
               window=64, softcap=50.0, q_start=200)
    check_attn("bf16 d=32 ragged (padded dims)", TOL_FLASH_BF16, "simt",
               (1, 4, 4, 70, 33, 32), bf16, causal=False)
    check_attn("fully masked rows are 0", TOL_FLASH_FP32, "simt",
               (1, 4, 1, 20, 40, hd), torch.float32, zero_rows=slice(0, 20),
               causal=True, window=4, q_start=100)
    def check_gm(name, tol, tile, *shape, routed=None, **kw):
        """One K4 case, which must run on ``tile``; ``routed``: the tokens
        of a routing (seeded with that number) whose rows the call is
        promised."""
        x, w, ep = grouped_case(gen, *shape, **kw)
        promises = {} if routed is None else routed_rows(
            x, routed, moe_cfg.moe.top_k, routed)
        before = dict(grouped_matmul.launches_by_tile)
        out = run_grouped(x, w, ep, **promises)
        ran = [t for t, n in grouped_matmul.launches_by_tile.items()
               if n != before[t]]
        ref = plain_grouped(x, w, ep)
        torch.cuda.synchronize()
        rel, diff = rel_err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all())
              and ran == [tile])
        results.append({"kernel": "grouped_matmul", "case": name,
                        "tile": ran, "rel": rel, "max_abs_err": diff,
                        "tol": tol, "ok": ok})

    e, dm, fe = moe_cfg.moe.n_experts, moe_cfg.d_model, \
        moe_cfg.moe.d_ff_expert
    # capacity at T = 884, 360 and decode, each on the tile the rule names,
    # with every row full and with the rows of a seeded routing
    for tokens, c in ((884, 144), (360, 64), (MAX_BATCH, 8)):
        tile = "tc" if c > MAX_ROWS_DECODE else "decode"
        for routed in (None, tokens):
            tag = "" if routed is None else f" rows of {tokens} tokens"
            check_gm(f"wi GLU-silu ({e},{c},{dm})@({e},{dm},{2 * fe}){tag}",
                     TOL_BF16, tile, e, c, dm, 2 * fe, bf16, glu=True,
                     act="silu", routed=routed)
            check_gm(f"wo ({e},{c},{fe})@({e},{fe},{dm}){tag}", TOL_BF16,
                     tile, e, c, fe, dm, bf16, routed=routed)
    check_gm("ragged fp32 (5,33,72)@(5,72,200) GLU-gelu", TOL_FP32, "simt",
             5, 33, 72, 200, torch.float32, glu=True, act="gelu")
    check_gm("fp16 ragged C (3,70,520)@(3,520,384) GLU-silu", TOL_BF16, "tc",
             3, 70, 520, 384, torch.float16, glu=True, act="silu")
    check_gm("int8 exact (8,40,256)@(8,256,96)", 0.0, "simt", 8, 40, 256,
             96, torch.int8)
    check_gm("int8 exact decode (4,8,100,70)", 0.0, "decode", 4, 8, 100, 70,
             torch.int8)

    def check_q(name, x):
        q, scale = run_quant(x)
        q_ref, scale_ref = plain_quant(x)
        torch.cuda.synchronize()
        diff = max((q.int() - q_ref.int()).abs().max().item(),
                   (scale - scale_ref).abs().max().item())
        ok = bool(torch.equal(q, q_ref) and torch.equal(scale, scale_ref))
        results.append({"kernel": "quantize_rowwise", "case": name,
                        "max_abs_err": diff,
                        "q_mismatches": int((q != q_ref).sum()),
                        "tol": 0.0, "ok": ok})

    rows = MAX_BATCH * s_max
    for m, k, dt in ((rows, d, bf16), (rows, ff, bf16), (MAX_BATCH, d, bf16),
                     (rows, d, torch.float32), (rows, ff, torch.float32)):
        check_q(f"{str(dt)[6:]} ({m},{k})", (_rand(gen, (m, k),
                                                    torch.float32) * 3).to(dt))
    # the register path takes rows of whole 16-byte vectors of at most
    # 16 x 768 elements from an aligned base (all the cases above); the
    # loop path the rest
    check_q("ragged fp32 (37,200)", _rand(gen, (37, 200), torch.float32))
    check_q("loop path: ragged K fp32 (37,201)",
            _rand(gen, (37, 201), torch.float32))
    check_q("loop path: K past the register limit fp32 (3,16400)",
            _rand(gen, (3, 16400), torch.float32))
    check_q("loop path: unaligned base fp32 (6,512)",
            _rand(gen, (6 * 512 + 1,), torch.float32)[1:].view(6, 512))
    check_q("zero row and .5 ties fp32 (6,4096)",
            ties_rows(gen, 6, d, torch.float32))
    check_q("zero row and .5 ties bf16 (6,4096)", ties_rows(gen, 6, d, bf16))

    # each tensor-core tile launched from a thread that never set its
    # device: every launcher binds its operands' card itself
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan

    def check_thread(name, wrapper, run, ref, tol):
        before = wrapper.launches_by_tile["tc"]
        out = in_fresh_thread(run)
        torch.cuda.synchronize()
        rel, diff = row_rel_err(out, ref)
        ok = (wrapper.launches_by_tile["tc"] == before + 1 and rel <= tol
              and out.shape == ref.shape
              and bool(torch.isfinite(out.double()).all()))
        results.append({"kernel": name, "case": "tc tile from a fresh "
                        "thread", "rel": rel, "max_abs_err": diff,
                        "tol": tol, "ok": ok})

    a, b, ep, ops = matmul_case(gen, 256, 512, 1024, bf16, glu=True,
                                act="silu")
    check_thread("fused_matmul", fused_matmul,
                 lambda: run_matmul(a, b, ep, ops),
                 plain_matmul(a, b, ep, ops), TOL_BF16)
    x, w, ep = grouped_case(gen, 4, 144, 256, 512, bf16, glu=True,
                            act="silu")
    check_thread("grouped_matmul", grouped_matmul,
                 lambda: run_grouped(x, w, ep), plain_grouped(x, w, ep),
                 TOL_BF16)
    q, k, v = attention_case(gen, 2, 4, 2, 128, 128, 128, bf16)
    kw = dict(sm_scale=128 ** -0.5, causal=True, window=0, softcap=0.0,
              q_start=0)
    check_thread("flash_attention", flash_attention,
                 lambda: run_attention(q, k, v, **kw),
                 plain_attention(q, k, v, **kw), TOL_FLASH_BF16)
    wkv = wkv_case(gen, 2, 4, 100, 64, bf16, s0=True)
    check_thread("rwkv6_wkv", rwkv6_scan,
                 lambda: run_wkv(*wkv, chunk=64)[0],
                 plain_wkv(*wkv, chunk=64)[0], TOL_BF16)

    # K3, K5 and K6, one call each at its path's shape, counted on the
    # card and on meta copies of its inputs (the dry run)
    g_rnn = get_config(GRIFFIN_ARCH).rnn.d_rnn
    for name, run, args in (
            ("quantize_rowwise", run_quant,
             (_rand(gen, (MAX_BATCH * s_max, d), torch.float32),)),
            ("rglru_scan", run_lru,
             lru_case(gen, MAX_BATCH, s_max, g_rnn, h0=True)),
            ("rwkv6_wkv", lambda *a: run_wkv(*a, chunk=64),
             wkv_case(gen, MAX_BATCH, 64, s_max, 64, bf16, s0=True,
                      transposed=True))):
        results.append(counted_case(name, run, args))
    emit({"phase": "kernels", "cases": results})
    require(all(r["ok"] for r in results),
            "kernel mismatch: " + ", ".join(r["case"] for r in results
                                           if not r["ok"]))
    return results


def counted_case(name, run, args):
    """``run(*args)``, one call of kernel ``name``'s wrapper, under the
    cost counter on the card and on meta copies of ``args``: the same
    launch, FLOPs and bytes on both sides (``core.hlo_cost``), the aten
    ops around the launch included."""
    from repro_torch.core import hlo_cost
    costs = {}
    for device in ("cuda", "meta"):
        xs = [a.to(device) if torch.is_tensor(a) else a for a in args]
        with torch.no_grad(), hlo_cost.counting() as counter:
            run(*xs)
        costs[device] = counter.cost
    card, meta = costs["cuda"], costs["meta"]
    same, ops_differ = compare_counts(card, meta)
    return {"kernel": name, "case": "counted on the card and on meta",
            "card": card.kernels, "meta": meta.kernels,
            "bytes": [card.bytes, meta.bytes], "ops_differ": ops_differ,
            "ok": same and card.kernels.get(name, {}).get("calls") == 1}


def compare_counts(card, meta):
    """(same, ops_differ) of two counts (``core.hlo_cost.HloCost``) of
    one run: ``same`` when launches by kernel, FLOPs and bytes are
    equal; ``ops_differ`` the aten ops whose rows are not, each as
    [card, meta]."""
    same = (card.kernels == meta.kernels and card.flops == meta.flops
            and card.bytes == meta.bytes)
    return same, {k: [card.ops.get(k), meta.ops.get(k)]
                  for k in set(card.ops) | set(meta.ops)
                  if card.ops.get(k) != meta.ops.get(k)}


def lru_case(gen, b, t, c, *, h0=False):
    """RG-LRU inputs as the recurrent block makes them: log_a =
    -8 softplus(lambda) sigmoid(r) with lambda in [2, 6]; fp32."""
    import torch.nn.functional as F
    lam = torch.rand(c, generator=gen, device="cuda") * 4.0 + 2.0
    gate = torch.sigmoid(_rand(gen, (b, t, c), torch.float32))
    log_a = -8.0 * F.softplus(lam) * gate
    x = _rand(gen, (b, t, c), torch.float32)
    return log_a, x, _rand(gen, (b, c), torch.float32) if h0 else None


def run_lru(log_a, x, h0=None):
    from repro_torch.kernels.rglru.ops import rglru_scan
    return rglru_scan(log_a, x, h0)


def plain_lru(log_a, x, h0=None):
    from repro_torch.kernels.rglru.rglru import rglru_scan_plain
    return rglru_scan_plain(log_a, x, h0)


def wkv_case(gen, b, h, t, c, dtype, *, s0=False, lw_value=None,
             transposed=False):
    """WKV inputs: r, k, v in ``dtype``; lw = -exp(clip(w, -8, 6)) in
    fp32 (the model's clip), or the constant ``lw_value``; u, s0 fp32.
    ``transposed``: r, k, v and lw are (B, T, H, C) memory seen as
    (B, H, T, C), as ``time_mix`` passes them."""
    shape = (b, t, h, c) if transposed else (b, h, t, c)

    def view(x):
        return x.transpose(1, 2) if transposed else x
    r, k, v = (view(_rand(gen, shape, dtype)) for _ in range(3))
    if lw_value is None:
        w = _rand(gen, shape, torch.float32) * 1.5 - 1.0
        lw = view(-torch.exp(torch.clamp(w, -8.0, 6.0)))
    else:
        lw = view(torch.full(shape, lw_value, device="cuda"))
    u = _rand(gen, (h, c), torch.float32) * 0.3
    state = _rand(gen, (b, h, c, c), torch.float32) * 0.3 if s0 else None
    return r, k, v, lw, u, state


def run_wkv(r, k, v, lw, u, s0=None, *, chunk):
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    return rwkv6_scan(r, k, v, lw, u, chunk=chunk, initial_state=s0)


def plain_wkv(r, k, v, lw, u, s0=None, *, chunk):
    from repro_torch.kernels.rwkv6.rwkv6 import rwkv6_chunked
    return rwkv6_chunked(r, k, v, lw, u, chunk=chunk, initial_state=s0)


def phase_kernels_recurrent(g_cfg, r_cfg, s_max):
    """K5 and K6 at the recurrent serving paths' shapes, K2 at head_dim
    256, each against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    results = []

    def record(kernel, name, out, ref, tol, extra_ok=True, err=rel_err):
        torch.cuda.synchronize()
        rel, diff = err(out, ref)
        ok = (out.dtype == ref.dtype and out.shape == ref.shape
              and rel <= tol and bool(torch.isfinite(out.double()).all())
              and extra_ok)
        results.append({"kernel": kernel, "case": name, "rel": rel,
                        "max_abs_err": diff, "tol": tol, "ok": ok})

    # K5 keeps each channel's chain in one thread, in time order, with the
    # plain version's roundings: every case must equal it bit for bit
    # (max_abs_err 0), at both prefill passes' shapes, ragged and T = 1.
    b, c = MAX_BATCH, g_cfg.rnn.d_rnn
    s_short = min(padded_lengths(prompt_lengths()[0]))
    for name, shape, h0 in ((f"path ({b},{s_max},{c})", (b, s_max, c), False),
                            (f"path ({b},{s_max},{c}) with h0",
                             (b, s_max, c), True),
                            (f"path ({b},{s_short},{c}) with h0",
                             (b, s_short, c), True),
                            ("ragged (3,37,300) with h0", (3, 37, 300), True),
                            ("ragged C (3,40,17)", (3, 40, 17), False),
                            ("T = 1 (2,1,64)", (2, 1, 64), False)):
        log_a, x, init = lru_case(gen, *shape, h0=h0)
        (h, h_last), (ref, ref_last) = (run_lru(log_a, x, init),
                                        plain_lru(log_a, x, init))
        record("rglru_scan", name, h, ref, TOL_FP32,
               extra_ok=bool(torch.equal(h, ref)))
        record("rglru_scan", name + ": h_T", h_last, ref_last, TOL_FP32,
               extra_ok=bool(torch.equal(h_last, ref_last)))
    # log_a -> 0: a -> 1 and beta -> 0, a pure integrator that keeps h0
    _, x, init = lru_case(gen, b, s_max, c, h0=True)
    log_a = torch.full_like(x, -1e-9)
    (h, h_last), (ref, _) = run_lru(log_a, x, init), plain_lru(log_a, x, init)
    record("rglru_scan", "log_a -> 0 keeps h0", h, ref, TOL_FP32,
           extra_ok=bool((h_last - init).abs().max() < 0.05
                         and torch.equal(h, ref)))

    # K6 on the tile each case must run on: bf16 and fp16 at head size 64
    # on the tensor-core tile, fp32 on the SIMT tile.  The output is held
    # against the plain version over the whole tensor and, in 16 bits, row
    # by row too (each token's row against its own max |ref|, as K2's);
    # the fp32 state at 1e-4 on both tiles; a second run must repeat the
    # first bit for bit (no atomics).
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    hh, hs = r_cfg.n_heads, r_cfg.rwkv.head_size
    path = (b, hh, s_max, hs)
    e6, e_8 = -float(np.exp(6.0)), -float(np.exp(-8.0))

    def run_tiled(args, chunk):
        before = dict(rwkv6_scan.launches_by_tile)
        out = run_wkv(*args, chunk=chunk)
        ran = [t for t, n in rwkv6_scan.launches_by_tile.items()
               if n != before[t]]
        return out, ran

    def record_wkv(name, o, s, ref, ref_s, dt, extra_ok, **info):
        tol = TOL_WKV_FP32 if dt == f32 else TOL_BF16
        record("rwkv6_wkv", name, o, ref, tol, extra_ok=extra_ok)
        results[-1].update(info)
        if dt != f32:
            record("rwkv6_wkv", name + ": row by row", o, ref, TOL_BF16,
                   err=row_rel_err)
        record("rwkv6_wkv", name + ": state", s, ref_s, TOL_WKV_FP32)

    wkv_cases = [
        (f"path {path} fp32 chunk 32", path, f32, 32, "simt", {}),
        ("ragged (2,8,100,64) fp32 chunk 64 with state", (2, 8, 100, 64),
         f32, 64, "simt", dict(s0=True)),
        ("lw = -exp(6) fp32 chunk 64", path, f32, 64, "simt",
         dict(lw_value=e6)),
        ("lw = -exp(-8) fp32 chunk 64", path, f32, 64, "simt",
         dict(lw_value=e_8)),
        ("lw = -exp(6) bf16 chunk 64", path, bf16, 64, "tc",
         dict(lw_value=e6)),
        ("lw = -exp(-8) bf16 chunk 64", path, bf16, 64, "tc",
         dict(lw_value=e_8))]
    for dt in (bf16, f16):
        tag = str(dt)[6:]
        wkv_cases += [
            (f"path {path} {tag} chunk 64 with state", path, dt, 64, "tc",
             dict(s0=True)),
            (f"path {path} {tag} chunk 32", path, dt, 32, "tc", {}),
            (f"ragged (2,8,100,64) {tag} chunk 64 with state",
             (2, 8, 100, 64), dt, 64, "tc", dict(s0=True)),
            (f"ragged (2,8,5,64) {tag} chunk 32 with state", (2, 8, 5, 64),
             dt, 32, "tc", dict(s0=True)),
            (f"path {path} {tag} chunk 64 with state, (B, T, H, C) views",
             path, dt, 64, "tc", dict(s0=True, transposed=True))]
    for name, shape, dt, chunk, tile, kw in wkv_cases:
        args = wkv_case(gen, *shape, dt, **kw)
        (o, s), ran = run_tiled(args, chunk)
        o2, s2 = run_wkv(*args, chunk=chunk)
        same = bool(torch.equal(o, o2) and torch.equal(s, s2))
        ref, ref_s = plain_wkv(*args, chunk=chunk)
        record_wkv(name, o, s, ref, ref_s, dt, ran == [tile] and same,
                   tile=ran, bit_identical_rerun=same)
    # two calls with the state carried equal one call, on each tile
    for dt, tile in ((f32, "simt"), (bf16, "tc")):
        r, k, v, lw, u, _ = wkv_case(gen, *path, dt)
        (o, s), ran = run_tiled((r, k, v, lw, u), 64)
        cut = s_max // 2
        (o1, s1), ran1 = run_tiled(
            (*(z[:, :, :cut] for z in (r, k, v, lw)), u), 64)
        (o2, s2), ran2 = run_tiled(
            (*(z[:, :, cut:] for z in (r, k, v, lw)), u, s1), 64)
        record_wkv(f"two calls ({cut} + rest) {str(dt)[6:]} with the state "
                   "carried", torch.cat([o1, o2], dim=2), s2, o, s, dt,
                   ran == ran1 == ran2 == [tile], tile=ran)

    from repro_torch.kernels.attention.ops import flash_attention
    hq, hkv, hd = g_cfg.n_heads, g_cfg.n_kv_heads, g_cfg.head_dim
    for name, shape, dt, window, tol, tile, transposed in (
            (f"path b={b} s={s_max} d={hd} MQA {hq}/{hkv} bf16",
             (b, hq, hkv, s_max, s_max, hd), bf16, g_cfg.window,
             TOL_FLASH_BF16, "tc", False),
            (f"path b={b} s={s_max} d={hd} MQA bf16 transposed views",
             (b, hq, hkv, s_max, s_max, hd), bf16, g_cfg.window,
             TOL_FLASH_BF16, "tc", True),
            (f"d={hd} MQA bf16 window 64", (2, hq, hkv, 300, 300, hd), bf16,
             64, TOL_FLASH_BF16, "tc", False),
            (f"d={hd} MQA fp32 window 64", (2, hq, hkv, 300, 300, hd), f32,
             64, TOL_FLASH_FP32, "simt", False)):
        q, kk, vv = attention_case(gen, *shape, dt, transposed=transposed)
        kw = dict(sm_scale=hd ** -0.5, causal=True, window=window,
                  softcap=0.0, q_start=0)
        before = dict(flash_attention.launches_by_tile)
        out = run_attention(q, kk, vv, **kw)
        ran = [t for t, n in flash_attention.launches_by_tile.items()
               if n != before[t]]
        record("flash_attention", name, out, plain_attention(q, kk, vv, **kw),
               tol, extra_ok=ran == [tile], err=row_rel_err)
        results[-1]["tile"] = ran
    emit({"phase": "kernels-recurrent", "cases": results})
    require(all(r["ok"] for r in results),
            "kernel mismatch: " + ", ".join(r["case"] for r in results
                                           if not r["ok"]))


# ---------------------------------------------------------------------------
# Parity: fp32 full width, cut in depth, kernel route against the torch
# route (yi-6b, olmoe-1b-7b, recurrentgemma-2b, rwkv6-7b).
# ---------------------------------------------------------------------------

def phase_parity(arch, phase, n_layers=PARITY_LAYERS, dtype=torch.float32,
                 tol=TOL_PATH):
    """Kernel route against torch route; in fp32 the greedy tokens must
    match too, in bf16 they are reported (see ``TOL_PATH_BF16``).  The
    torch route decodes the kernel route's greedy tokens; an MoE model in
    bf16 also routes each token to the kernel route's experts, since a
    bf16 rounding flips near-tied top-k choices and a flipped choice moves
    that token's output by far more than the tolerance (the torch route's
    own choices are still counted: ``expert_choices_differing``).
    Whisper and InternVL take seeded stub-frontend inputs that differ by
    row (``stub_inputs``); InternVL's 64 text tokens follow its 256
    vision-prefix positions."""
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree
    from repro_torch.models import common
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.base import family_module
    cfg = get_config(arch).with_(n_layers=n_layers, dtype=dtype,
                                 kv_cache_dtype=dtype)
    mod = family_module(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = mod.init(cfg, gen, "cuda")
    rng = np.random.default_rng(3)
    s = cfg.vision_prefix + 64
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, s))).cuda()
    batch = {"tokens": tokens, **stub_inputs(cfg, 4, gen)}
    picks = {}                  # route -> each router call's expert sets
    chosen = []                 # the kernel route's (gate, index) per call
    follow = cfg.moe is not None and dtype == torch.bfloat16

    def run(route, rcfg=cfg, rparams=params):
        inner = moe_lib.route
        kernel_choice = iter(chosen)

        def recording(rcfg, x2d, w_router):
            gate, idx = inner(rcfg, x2d, w_router)
            picks.setdefault(route, []).append(idx.sort(dim=-1).values)
            if route == "kernel":
                chosen.append((gate, idx))
            elif follow:
                return next(kernel_choice)
            return gate, idx
        prev = backend.set_default_matmul_backend(route)
        moe_lib.route = recording
        try:
            rcfg = rcfg.with_(backend=route)
            cache = mod.init_cache(rcfg, 4, s + PARITY_DECODE + 1,
                                   device="cuda")
            logits, cache = mod.prefill(rcfg, rparams, batch, cache)
            steps = [logits]
            for i in range(PARITY_DECODE):
                tok = forced[i] if forced else steps[-1].argmax(-1)
                logits, cache = mod.decode_step(rcfg, rparams, tok[:, None],
                                                cache, s + i)
                steps.append(logits)
            torch.cuda.synchronize()
            return steps
        finally:
            backend.set_default_matmul_backend(prev)
            moe_lib.route = inner

    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    tiled = {"fused_matmul": fused_matmul}
    if cfg.moe is not None:
        tiled["grouped_matmul"] = grouped_matmul
    if cfg.family == "rwkv6":                   # RWKV-6 has no attention
        from repro_torch.kernels.rwkv6.ops import rwkv6_scan
        tiled["rwkv6_scan"] = rwkv6_scan
    else:
        tiled["flash_attention"] = flash_attention
    # the tiles each kernel must run on, and no other: in bf16 K1 and K4 on
    # their tensor-core and decode tiles, K2 and K6 on their tensor-core
    # tiles; in fp32 K2 and K6 on their SIMT tiles
    want = ({"fused_matmul": ("tc", "decode"),
             "grouped_matmul": ("tc", "decode"), "flash_attention": ("tc",),
             "rwkv6_scan": ("tc",)}
            if dtype == torch.bfloat16 else {"flash_attention": ("simt",),
                                             "rwkv6_scan": ("simt",)})
    forced = []
    for fn in tiled.values():
        fn.launches_by_tile = dict.fromkeys(fn.launches_by_tile, 0)
    kern = run("kernel")
    tiles = {name: dict(fn.launches_by_tile) for name, fn in tiled.items()}
    forced.extend(s.argmax(-1) for s in kern[:-1])
    plain = run("torch")
    errs = [rel_err(k, p)[0] for k, p in zip(kern, plain)]
    same = [bool(torch.equal(k.argmax(-1), p.argmax(-1)))
            for k, p in zip(kern, plain)]
    finite = all(bool(torch.isfinite(k).all()) for k in kern)
    line = {"phase": phase, "config": f"{arch} width, {n_layers} "
            f"layers, {str(dtype)[6:]}", "rel_err": errs, "tol": tol,
            "tokens_equal": same, "finite": finite}
    if cfg.moe is not None:
        pairs = list(zip(picks["kernel"], picks["torch"]))
        line["expert_choices"] = sum(a.shape[0] for a, _ in pairs)
        line["expert_choices_differing"] = sum(
            int((a != b).any(-1).sum()) for a, b in pairs)
        line["experts_follow_kernel_route"] = follow
    for name, by_tile in tiles.items():
        line[f"{name}_by_tile_kernel_route"] = by_tile
    if dtype == torch.bfloat16:
        # how far each bf16 route lies from the same weights run in fp32
        ref = run("torch", cfg.with_(dtype=torch.float32,
                                     kv_cache_dtype=torch.float32),
                  tree.tree_map(lambda x: x.float() if x.is_floating_point()
                                else x, params))
        line["rel_err_vs_fp32"] = {
            route: [rel_err(x.float(), r)[0] for x, r in zip(out, ref)]
            for route, out in (("kernel", kern), ("torch", plain))}
        if "flash_attention" in tiled:
            # the share of the gap that K2's tensor-core tile makes by
            # rounding P to bf16 before P V: the torch route again with
            # that rounding (``pv_bf16``) in its prefill attention
            chunked = common.attention_chunked
            common.attention_chunked = functools.partial(chunked,
                                                         pv_bf16=True)
            try:
                rounded = run("torch")
            finally:
                common.attention_chunked = chunked
            line["rel_err_vs_torch_pv_bf16"] = {
                route: [rel_err(x, r)[0] for x, r in zip(out, rounded)]
                for route, out in (("kernel", kern), ("torch", plain))}
    emit(line)
    require(finite and all(e <= tol for e in errs)
            and (all(same) or dtype != torch.float32),
            f"{arch}: kernel route disagrees with the torch route")
    for name, by_tile in tiles.items():
        on = want.get(name)
        require(on is None or (
            all(by_tile[t] > 0 for t in on)
            and all(n == 0 for t, n in by_tile.items() if t not in on)),
            f"{arch} {str(dtype)[6:]}: {name} ran on {by_tile}, not on its "
            f"{' and '.join(on or ())} tiles alone")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Serving: full-width, full-depth yi-6b, olmoe-1b-7b, recurrentgemma-2b
# and rwkv6-7b through the kernels.
# ---------------------------------------------------------------------------

def phase_serve(arch, phase, counters, reckoned):
    """``counters``: kernel name -> wrapper whose ``launches`` the path
    must raise above 0; ``reckoned``: kernel name (K1, K2 and K4 where the
    path has them) -> its launches by tile, reckoned from the traffic,
    which the path must match.  A model with a vision prefix takes each
    prompt as that many placeholder tokens (id 0) before the text, which
    the prefix's embeddings replace; ``ServingEngine.run`` adds zero
    stub-frontend inputs.  Peak device memory is read twice: over the
    weights' initialisation and over the run."""
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree
    from repro_torch.models.base import family_module
    from repro_torch.serving.engine import ServingEngine

    require(backend.default_matmul_backend() == "kernel",
            "the default matmul route is not the kernel")
    cfg = get_config(arch)
    require(cfg.backend == "kernel" and cfg.dtype == torch.bfloat16,
            f"{arch} does not default to the kernel route in bf16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = family_module(cfg).init(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(x.numel() for x in tree.leaves(params))

    lengths, rng = prompt_lengths()
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH,
                        cache_len=CACHE_LEN)
    prefix = torch.zeros(cfg.vision_prefix, dtype=torch.int64)
    for n in lengths:
        eng.submit(torch.cat([prefix, torch.from_numpy(
            rng.integers(0, cfg.vocab_size, n))]))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    for name in reckoned:
        counters[name].launches_by_tile = dict.fromkeys(
            counters[name].launches_by_tile, 0)
    t0 = time.perf_counter()
    outs = eng.run(max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    by_tile = {f"{name}_by_tile": dict(counters[name].launches_by_tile)
               for name in reckoned}
    batches = [{"padded_prompt": cfg.vision_prefix + int(
                    max(lengths[i * MAX_BATCH:(i + 1) * MAX_BATCH])),
                "prefill_ms": r.prefill_ms(),
                "decode_step_ms": r.decode_step_ms()}
               for i, r in enumerate(eng.results)]
    tokens = sum(int(o.numel()) for o in outs)
    ok_tokens = (len(outs) == N_REQUESTS
                 and all(o.shape == (MAX_NEW,) for o in outs)
                 and bool(((torch.stack(outs) >= 0)
                           & (torch.stack(outs) < cfg.padded_vocab)).all()))
    finite = all(bool(torch.isfinite(r.logits_last).all())
                 for r in eng.results)
    emit({"phase": phase, "config": f"{arch} full width and depth "
          f"({cfg.n_layers} layers), bf16, seeded random weights",
          "params": n_params, "init_s": init_s,
          "prompt_lengths": [cfg.vision_prefix + int(x) for x in lengths],
          "max_new_tokens": MAX_NEW, "batches": batches,
          "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
          "max_memory_allocated_init": init_peak,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, **by_tile,
          **{f"{name}_by_tile_reckoned": n for name, n in reckoned.items()},
          "tokens_ok": ok_tokens,
          "logits_finite": finite,
          "first_request": outs[0].tolist()})
    require(ok_tokens and finite, f"{arch}: serving produced malformed "
            "output")
    require(all(v > 0 for v in launches.values()),
            f"{arch}: a kernel of the path never launched: {launches}")
    for name, n in reckoned.items():
        require(by_tile[f"{name}_by_tile"] == n, f"{arch}: {name} ran "
                f"{by_tile[f'{name}_by_tile']} by tile, reckoned {n}")
    del params, eng
    torch.cuda.empty_cache()
    return {**launches, **by_tile}


# ---------------------------------------------------------------------------
# The TaskGraph executed on the card: one IR, priced by the DES and run
# through the backend registry, one K1 launch per matrix tile.
# ---------------------------------------------------------------------------

def _reckon_tiles(graph):
    """K1's launches by tile for ``graph``: one per matrix node, on the
    tile ``select_tile`` names for its accumulator-tile call."""
    from repro_torch.core.precision import policy
    from repro_torch.kernels.matmul.matmul import TILES, select_tile
    out = dict.fromkeys(TILES, 0)
    for node in graph.matmul_nodes():
        t = node.tile
        out[select_tile(t.m, t.n, node.task.k,
                        policy(node.task.data_type).in_dtype, False,
                        True)] += 1
    return out


def _operands(gen, shapes, dtype):
    """``{gemm label: (a, b)}`` on the card for ``shapes``, ``{gemm label:
    (m, k, n)}``: int8 in [-8, 8), the range of the reference's
    ``BatchSchedule.example_operands``, or bf16 normals with B scaled as
    a weight."""
    ops = {}
    for label, (m, k, n) in shapes.items():
        if dtype == torch.int8:
            ops[label] = tuple(
                torch.randint(-8, 8, shape, generator=gen, dtype=torch.int8,
                              device="cuda") for shape in ((m, k), (k, n)))
        else:
            a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            b = (torch.randn((k, n), generator=gen, device="cuda")
                 / k ** 0.5).to(dtype)
            ops[label] = (a, b)
    return ops


def _timed_run(eng, graph, ops):
    """``eng.run_graph`` with K1's counts set to 0 just before and read
    just after: (result, host-clock seconds ending in a synchronize,
    launches by tile, the host's time in ``AsyncMatmulEngine.dispatch``:
    asyncMatMul of one tile, K1's wrapper and launch included)."""
    from repro_torch.core.engine import AsyncMatmulEngine
    from repro_torch.kernels.matmul.ops import fused_matmul
    inner, spent = AsyncMatmulEngine.dispatch, []

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(self, *args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    fused_matmul.launches = 0
    fused_matmul.launches_by_tile = dict.fromkeys(
        fused_matmul.launches_by_tile, 0)
    AsyncMatmulEngine.dispatch = timed
    try:
        t0 = time.perf_counter()
        r = eng.run_graph(graph, ops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        AsyncMatmulEngine.dispatch = inner
    by_tile = dict(fused_matmul.launches_by_tile)
    require(fused_matmul.launches == sum(by_tile.values()),
            "K1's launch count and its count by tile disagree")
    host = {"dispatch_host_s": sum(spent),
            "dispatch_host_us_median": statistics.median(spent) * 1e6,
            "dispatch_host_us_mean": sum(spent) / len(spent) * 1e6}
    return r, wall, by_tile, host


def _k1_call_host_us(graph, ops):
    """Host µs (medians) of one K1 call a matrix tile of ``graph``, made
    directly on the current stream, outside the engine: on the graph's B
    column slices, which K1's wrapper copies contiguous on every call,
    and on contiguous copies made beforehand.  Measurement only: the
    launches are not the path's."""
    from repro_torch.core.fusion import Epilogue, cute_matmul
    ep = Epilogue(out_dtype=torch.int32)
    tiles = []
    for node in graph.matmul_nodes():
        a, b = ops[node.layer]
        t = node.tile
        b_t = b[:, t.n0:t.n0 + t.n]
        tiles.append((a[t.m0:t.m0 + t.m], b_t, b_t.contiguous()))
    out = {}
    for name, pick in (("strided_b", 1), ("contiguous_b", 2)):
        spent = []
        torch.cuda.synchronize()
        for tile in tiles:
            t0 = time.perf_counter()
            cute_matmul(tile[0], tile[pick], epilogue=ep, backend="kernel")
            spent.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        out[name] = statistics.median(spent) * 1e6
    return out


def phase_exec(cfg, s_max, card):
    """yi-6b's serving step at full width as a TaskGraph, lowered and run
    through the backend registry (``repro_torch.backend``):

    * ``get("kernel")`` runs the prefill step (the 4 x ``s_max`` padded
      batch) and the decode step (4 tokens), int8, TILE granularity at
      ``CASE_STUDY``'s 64 x 64 tiles: every matrix tile is one K1 launch
      (simt at prefill, decode at decode), and every GEMM's output must
      equal one ``cute_matmul`` of the same operands, bit for bit, on the
      torch route (exact through float64) and on the kernel route;
    * ``get("kernel", granularity="panel")`` runs one bf16 GEMM with a
      fused GLU silu, yi-6b's gate-up projection: K1's tensor-core tile
      on every tile, the regions' epilogues in plain ops, held within
      ``TOL_PATH_BF16`` of one ``cute_matmul`` on each route;
    * ``get("desim")`` runs the decode step's graph again: simulated
      cycles of the paper's CPU matrix unit (not card time) and the
      numbers, which must equal the kernel backend's bit for bit.

    K1's launches by tile must equal the counts reckoned from each graph.
    The default metrics registry is on for the phase: each ``run_graph``
    is counted and timed per backend."""
    from repro_torch import backend, obs
    from repro_torch.core.fusion import Epilogue, cute_matmul
    from repro_torch.core.precision import DataType
    from repro_torch.core.task import MatMulTask
    from repro_torch.serving.engine import _step_layer
    from repro_torch.sim.lower import gemm_labels

    require(backend.default_matmul_backend() == "kernel",
            "the default matmul route is not the kernel")
    gen = torch.Generator(device="cuda").manual_seed(6)
    reg = obs.default_registry()
    reg.clear()
    obs.enable_metrics()
    graphs, total = {}, {}
    try:
        kern = backend.get("kernel")
        outs = {}
        for step, tokens in (("prefill", MAX_BATCH * s_max),
                             ("decode", MAX_BATCH)):
            layer = _step_layer(cfg, step, tokens, cfg.n_layers)
            t0 = time.perf_counter()
            graph = kern.lower([layer])
            lower_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            sim = backend.get("desim").run_graph(graph)
            des_s = time.perf_counter() - t0
            ops = _operands(gen, {f"{step}/g{i}": (t.m, t.k, t.n)
                                  for i, t in enumerate(layer.gemms)},
                            torch.int8)
            require(list(ops) == gemm_labels(graph),
                    f"exec {step}: the graph's GEMMs are not the step's")
            r, wall, by_tile, host = _timed_run(kern, graph, ops)
            reckoned = _reckon_tiles(graph)
            exact = {}
            for route in ("torch", "kernel"):
                exact[route] = all(
                    torch.equal(r.outputs[label],
                                cute_matmul(a, b, backend=route))
                    for label, (a, b) in ops.items())
            on_card = all(o.is_cuda and o.dtype == torch.int32
                          for o in r.outputs.values())
            outs[step] = (graph, ops, r.outputs)
            if step == "decode":
                host["k1_call_host_us_median"] = _k1_call_host_us(graph,
                                                                  ops)
            graphs[step] = {
                "step": f"{ARCH} {step}, {tokens} tokens, int8, 64x64 "
                        "tiles, TILE granularity, fused",
                "gemms_mnk": {f"{step}/g{i}": [t.m, t.n, t.k]
                              for i, t in enumerate(layer.gemms)},
                **graph.stats(), "lower_host_s": lower_s,
                "des_host_s": des_s,
                "des_simulated_cycles": sim.cycles,
                "des_simulated_matrix_utilization": sim.utilization,
                "run_graph_s": wall,
                "wall_us_per_tile": wall / graph.stats()["matmul"] * 1e6,
                **host, "fused_matmul_by_tile": by_tile,
                "fused_matmul_by_tile_reckoned": reckoned,
                "bit_exact_vs_cute_matmul": exact, "outputs_on_card": on_card}
            require(by_tile == reckoned, f"exec {step}: K1 ran {by_tile} "
                    f"by tile, reckoned {reckoned}")
            require(all(exact.values()) and on_card,
                    f"exec {step}: the graph's outputs differ from "
                    f"cute_matmul: {exact}")
            for t_, n in by_tile.items():
                total[t_] = total.get(t_, 0) + n
            del r

        # the decode step once more, through the DES backend: both halves
        graph, ops, kern_outs = outs.pop("decode")
        r, wall, by_tile, host = _timed_run(backend.get("desim"), graph,
                                            ops)
        same = all(torch.equal(r.outputs[k], kern_outs[k])
                   for k in kern_outs)
        graphs["decode-desim"] = {
            "run_graph_s": wall, **host, "fused_matmul_by_tile": by_tile,
            "des_simulated_cycles": r.cycles,
            "des_simulated_seconds_at_unit_clock": r.seconds,
            "des_simulated_matrix_utilization": r.utilization,
            "outputs_equal_kernel_backend": same}
        require(by_tile == _reckon_tiles(graph), f"exec decode-desim: K1 "
                f"ran {by_tile} by tile")
        require(same, "exec: the desim backend's numbers differ from the "
                "kernel backend's")
        for t_, n in by_tile.items():
            total[t_] += n
        del outs, ops, kern_outs, r

        # one bf16 GEMM with a fused GLU, at PANEL granularity
        d, ff, rows = cfg.d_model, cfg.d_ff, MAX_BATCH * s_max
        panel = backend.get("kernel", granularity="panel")
        ep = Epilogue(activation=cfg.mlp_activation, glu=True,
                      out_dtype=torch.bfloat16)
        task = MatMulTask(m=rows, n=2 * ff, k=d, data_type=DataType.BF16)
        graph = panel.lower(task, epilogue=ep)
        a, b = _operands(gen, {"glu": (rows, d, 2 * ff)},
                         torch.bfloat16)["glu"]
        r, wall, by_tile, host = _timed_run(panel, graph,
                                            backend.MatMulOperands(a, b))
        reckoned = _reckon_tiles(graph)
        errs = {route: rel_err(r.output, cute_matmul(
            a, b.view(d, 2, ff), epilogue=ep, backend=route))[0]
            for route in ("torch", "kernel")}
        graphs["glu-bf16"] = {
            "step": f"{ARCH} gate-up projection ({rows},{d}) @ ({d},2x{ff}) "
                    f"bf16, GLU {cfg.mlp_activation}, PANEL granularity",
            **graph.stats(), "run_graph_s": wall,
            "wall_us_per_tile": wall / graph.stats()["matmul"] * 1e6,
            **host, "fused_matmul_by_tile": by_tile,
            "fused_matmul_by_tile_reckoned": reckoned,
            "rel_err_vs_cute_matmul": errs, "tol": TOL_PATH_BF16,
            "output_shape": list(r.output.shape),
            "finite": bool(torch.isfinite(r.output).all())}
        require(by_tile == reckoned, f"exec glu-bf16: K1 ran {by_tile} by "
                f"tile, reckoned {reckoned}")
        require(graphs["glu-bf16"]["finite"]
                and tuple(r.output.shape) == (rows, ff)
                and max(errs.values()) <= TOL_PATH_BF16,
                f"exec glu-bf16: {errs} against {TOL_PATH_BF16}")
        for t_, n in by_tile.items():
            total[t_] += n
        snap = reg.snapshot()
    finally:
        obs.disable_metrics()
        reg.clear()
    metrics = {
        "backend_calls_total": {
            row["labels"]["backend"]: row["value"]
            for row in snap["counters"]["backend_calls_total"]},
        "backend_seconds_p50": {
            row["labels"]["backend"]: row["p50"]
            for row in snap["histograms"]["backend_seconds"]}}
    emit({"phase": "exec", "card": card, "graphs": graphs,
          "fused_matmul_by_tile": total, "metrics": metrics,
          "note": "des_* cycles are simulated cycles of the paper's CPU "
                  "matrix unit (SHUTTLE, 2 GHz), not card time; "
                  "run_graph_s is the card's wall time on the host clock"})
    torch.cuda.empty_cache()
    return {"fused_matmul": sum(total.values()),
            "fused_matmul_by_tile": total}


# ---------------------------------------------------------------------------
# Paged attention: the block-table gather, then K2 as in the contiguous
# call.
# ---------------------------------------------------------------------------

def phase_paged(cfg, g_cfg, s_max):
    """``paged_flash_attention`` on a KV cache scattered into pages of
    ``PAGED_BLOCK`` tokens under a shuffled block table must equal the
    contiguous ``flash_attention`` call bit for bit, on the tile the
    contiguous call takes: yi-6b's prefill (bf16, tc tile), RecurrentGemma's
    d=256 MQA with a window that bites (bf16, tc tile) and yi-6b's in fp32
    (simt tile).  ``paged_decode_attention`` must equal ``decode_attention``
    at yi-6b's decode shape against a 512-slot cache, with and without a
    window.  K2's counts are set to 0 before each paged call and read after
    it; the contiguous calls are the comparison, not the path."""
    from repro_torch.kernels.attention.attention import tile_for
    from repro_torch.kernels.attention.ops import (decode_attention,
                                                   flash_attention)
    from repro_torch.kernels.attention.paged import (paged_decode_attention,
                                                     paged_flash_attention,
                                                     to_paged)
    gen = torch.Generator(device="cuda").manual_seed(8)
    path = dict.fromkeys(flash_attention.launches_by_tile, 0)
    cases = {}
    # (name, heads, kv heads, head_dim, dtype, window, the tile it must take)
    for name, h, hkv, d, dtype, window, tile in (
            (f"{ARCH} prefill", cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
             torch.bfloat16, 0, "tc"),
            (f"{GRIFFIN_ARCH} prefill, window 64", g_cfg.n_heads,
             g_cfg.n_kv_heads, g_cfg.head_dim, torch.bfloat16, 64, "tc"),
            (f"{ARCH} prefill fp32", cfg.n_heads, cfg.n_kv_heads,
             cfg.head_dim, torch.float32, 0, "simt")):
        q, k, v = attention_case(gen, MAX_BATCH, h, hkv, s_max, s_max, d,
                                 dtype)
        kw = dict(sm_scale=d ** -0.5, causal=True, window=window)
        ref = flash_attention(q, k, v, **kw)
        k_pages, v_pages, table = to_paged(k, v, PAGED_BLOCK, seed=1)
        torch.cuda.synchronize()
        flash_attention.launches_by_tile = dict.fromkeys(path, 0)
        out = paged_flash_attention(q, k_pages, v_pages, table,
                                    seq_len=s_max, **kw)
        torch.cuda.synchronize()
        by_tile = dict(flash_attention.launches_by_tile)
        for t_, n in by_tile.items():
            path[t_] += n
        cases[name] = {
            "q": list(q.shape), "kv": list(k.shape), "dtype": str(dtype)[6:],
            "pages": list(k_pages.shape), "table": list(table.shape),
            "by_tile": by_tile, "contiguous_tile": tile_for(q, k, v),
            "equal_contiguous": bool(torch.equal(out, ref)),
            "row_rel_err_vs_plain": row_rel_err(
                out, plain_attention(q, k, v, softcap=0.0, q_start=0,
                                     **kw))[0]}
        require(cases[name]["equal_contiguous"], f"paged {name}: differs "
                "from the contiguous flash_attention")
        require(by_tile == {**dict.fromkeys(path, 0), tile: 1}
                and cases[name]["contiguous_tile"] == tile,
                f"paged {name}: K2 ran {by_tile}, not once on {tile}")
    # decode: q (4, 32, 1, 128) against a 512-slot bf16 cache, cache_len
    # 222..237 (a prefill of 221 and 1..16 decode steps)
    q, k, v = attention_case(gen, MAX_BATCH, cfg.n_heads, cfg.n_kv_heads, 1,
                             CACHE_LEN, cfg.head_dim, torch.bfloat16)
    cache_len = torch.tensor([s_max + 1 + 5 * i for i in range(MAX_BATCH)],
                             device="cuda")
    k_pages, v_pages, table = to_paged(k, v, PAGED_BLOCK, seed=2)
    for window in (0, 128):
        name = f"{ARCH} decode, window {window}"
        out = paged_decode_attention(q, k_pages, v_pages, table, cache_len,
                                     seq_len=CACHE_LEN, window=window)
        ref = decode_attention(q, k, v, cache_len, window=window)
        cases[name] = {"q": list(q.shape), "kv": list(k.shape),
                       "cache_len": cache_len.tolist(),
                       "equal_contiguous": bool(torch.equal(out, ref))}
        require(cases[name]["equal_contiguous"], f"paged {name}: differs "
                "from decode_attention")
    emit({"phase": "paged", "block_tokens": PAGED_BLOCK, "cases": cases,
          "flash_attention_by_tile": path})
    return {"flash_attention": sum(path.values()),
            "flash_attention_by_tile": path}


# ---------------------------------------------------------------------------
# The planning front door: schedules priced by the DES and the analytical
# form, one executed through K1, then ``launch.serve --plan``.
# ---------------------------------------------------------------------------

def span_digest(log) -> str:
    """SHA-256 of a ``SpanLog``'s JSON (request, phase, start, end)."""
    import hashlib
    return hashlib.sha256(json.dumps(log.to_json(), sort_keys=True)
                          .encode()).hexdigest()


def launcher_text(raw: str) -> "tuple[str, ...]":
    """The launcher's ``[plan:…]`` / ``[online:…]`` lines and tables:
    its served tokens, metrics path and wall-clock seconds cut out."""
    return tuple(re.sub(r" in [0-9.]+s wall", " in _s wall", ln)
                 for ln in raw.splitlines()
                 if not re.match(r"served |  req\d+: |metrics snapshot -> ",
                                 ln))


def run_launcher(argv):
    """``launch.serve.main(argv)``: (its standard output, host seconds)."""
    import contextlib
    import io
    from repro_torch.launch import serve
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def plan_engine(cfg, prompts, gap=PLAN_ARRIVAL_GAP):
    """A planning-only ``ServingEngine(cfg, None)`` holding ``prompts``
    (lengths), request i arriving at i x ``gap`` cycles."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, None, max_batch=MAX_BATCH)
    for i, n in enumerate(prompts):
        eng.submit(torch.zeros(n, dtype=torch.int64),
                   arrival_time=i * gap)
    return eng


def price_cases(cfg, eng, cases, ref):
    """Each (backend, units, policy) of ``cases`` priced by
    ``evaluate_schedule`` and ``price_steps``: chosen policy, graph
    cycles, per-step cycles and ``decode_latency_stats`` must equal
    ``ref`` (the reference's, keyed "backend/policy"), and a span log
    must validate.  Returns (a line per case, host seconds)."""
    from repro_torch.serving.scheduler import (decode_latency_stats,
                                               price_steps)
    sweep, t_sweep = {}, time.perf_counter()
    for name, units, policy in cases:
        key = f"{name}/{policy}"
        t0 = time.perf_counter()
        sched, res = eng.evaluate_schedule(
            name, max_new_tokens=MAX_NEW, units=units, policy=policy,
            workload=False)
        steps = price_steps(sched, name)
        got = {"policy": sched.policy, "units": sched.units,
               "steps": len(sched.steps), "graph_cycles": res.cycles,
               "step_cycles": steps,
               "stats": decode_latency_stats(sched, steps, cfg.n_layers)}
        log = res.detail.get("span_log")
        sweep[key] = {"policy": got["policy"], "steps": got["steps"],
                      "graph_cycles": got["graph_cycles"],
                      "ttft_p99": got["stats"]["ttft_p99"],
                      "makespan": got["stats"]["makespan"],
                      "equal_reference": got == ref[key],
                      "span_violations": None if log is None
                      else len(log.validate()),
                      "host_s": time.perf_counter() - t0}
        require(got == ref[key], f"plan {key}: {got} differs from the "
                f"reference's {ref[key]}")
        require(log is None or not log.validate(),
                f"plan {key}: the span log does not validate")
    return sweep, time.perf_counter() - t_sweep


def _price_case(args):
    """``price_cases`` of one case on an engine of its own, in a process
    of the pool ``start_pricing`` spawns: (its line, or the failed
    check's text)."""
    cfg, prompts, case, ref = args
    torch.set_num_threads(1)
    try:
        sweep, _ = price_cases(cfg, plan_engine(cfg, prompts), (case,), ref)
    except PhaseFailed as e:
        return None, str(e)
    return sweep, None


def start_pricing(cfg, sweeps):
    """Start pricing each of ``sweeps`` ({tag: (prompts, cases, ref)}) as
    ``price_cases`` prices it, every case in a process of its own (a
    spawned pool over the host's cores: the DES is single-threaded host
    Python and a case holds no state of another); ``finish_pricing``
    collects it.  The card is not used, so the script starts it before
    the kernels' build and the phases that hold no host time."""
    import multiprocessing
    import os
    jobs = [(tag, (cfg, prompts, case, ref))
            for tag, (prompts, cases, ref) in reversed(sweeps.items())
            for case in cases]          # the last sweep's (longest) first
    pool = multiprocessing.get_context("spawn").Pool(
        min(len(jobs), os.cpu_count() or 1))
    t0, done_at = time.perf_counter(), []
    return (pool, pool.map_async(
        _price_case, [job for _, job in jobs], chunksize=1,
        callback=lambda _: done_at.append(time.perf_counter())),
        jobs, tuple(sweeps), t0, done_at)


def finish_pricing(started):
    """``start_pricing``'s results: {tag: (a line per case, the pool's
    wall seconds, from its start to its last case)}."""
    pool, pending, jobs, tags, t0, done_at = started
    try:
        done = pending.get()
    finally:
        pool.close()
        pool.join()
    wall = done_at[0] - t0
    out = {tag: ({}, wall) for tag in tags}
    for (tag, _), (line, err) in zip(jobs, done):
        require(err is None, err or "")
        out[tag][0].update(line)
    return out


def plan_sweeps():
    """Phase plan's two sweeps for ``start_pricing``."""
    return {"launcher": (PLAN_PROMPTS, PLAN_CASES, REFERENCE["plan"]),
            "serve": (serve_prompts(), PLAN_SERVE_CASES,
                      REFERENCE["plan_serve"])}


def phase_plan(cfg, launcher_reckoned, pricing):
    """Planning-only ``ServingEngine(cfg, None)``s (yi-6b at full width
    and depth) price the launcher's traffic (``PLAN_PROMPTS``) in each of
    ``PLAN_CASES`` and the serve traffic (``serve_prompts``) in each of
    ``PLAN_SERVE_CASES``, requests arriving every ``PLAN_ARRIVAL_GAP``
    cycles (``price_cases``, each case in a process of its own,
    ``start_pricing``, started with the script: equal to the
    reference's ``REFERENCE``,
    recorded by ``scripts/record_smoke_constants.py``; ``sweep_host_s``
    is the pool's wall).  The launcher
    traffic's full-prefill schedule then runs with ``example_operands`` on
    the card through ``desim`` (one unit) and ``desim-cluster`` (4 units,
    output-tile), TILE granularity: one K1 launch per matrix tile, by
    tile as reckoned from the graph; every GEMM equal to one
    ``cute_matmul`` bit for bit; the two backends' numbers equal; each
    run's cycles those of the pricing and its span log valid.  Last,
    ``launch.serve.main`` with ``--plan desim --metrics-out``: its plan
    lines equal the reference launcher's, and it serves its 6 requests on
    the card, K1's and K2's launches by tile equal to
    ``launcher_reckoned``.  All cycles are simulated cycles of the
    paper's CPU matrix unit, not card time."""
    from repro_torch import backend
    from repro_torch.core.fusion import cute_matmul
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.serving.scheduler import backend_kwargs_for
    ref = REFERENCE["plan"]
    priced = finish_pricing(pricing)
    (sweep, sweep_s), (serve_sweep, serve_sweep_s) = (
        priced["launcher"], priced["serve"])
    eng = plan_engine(cfg, PLAN_PROMPTS)

    # the full-prefill schedule, executed through K1 on two backends
    scheds = {"desim": eng.plan(MAX_NEW, units=1),
              "desim-cluster": eng.plan(MAX_NEW, units=4)}
    require(repr(scheds["desim"].layers)
            == repr(scheds["desim-cluster"].layers),
            "plan: the 1- and 4-unit schedules differ in their steps")
    ops = scheds["desim-cluster"].example_operands(0, "cuda")
    runs, outs, total = {}, {}, {}
    for name, sched in scheds.items():
        be = backend.get(name, **backend_kwargs_for(sched,
                                                    units=sched.units))
        graph = be.lower(sched)
        if hasattr(be, "partition"):
            graph = be.partition(graph).graph
        reckoned = _reckon_tiles(graph)
        torch.cuda.synchronize()
        fused_matmul.launches = 0
        fused_matmul.launches_by_tile = dict.fromkeys(reckoned, 0)
        t0 = time.perf_counter()
        r = eng.run_schedule(sched, name, operands=ops, workload=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_tile = dict(fused_matmul.launches_by_tile)
        launched = fused_matmul.launches
        exact = all(torch.equal(r.outputs[label],
                                cute_matmul(a, b, backend="kernel"))
                    for label, (a, b) in ops.items())
        priced = ref[f"{name}/full-prefill"]["graph_cycles"]
        bad_spans = r.detail["span_log"].validate()
        runs[name] = {"units": sched.units, "matmul_nodes":
                      graph.stats()["matmul"], "run_schedule_s": wall,
                      "fused_matmul_by_tile": by_tile,
                      "fused_matmul_by_tile_reckoned": reckoned,
                      "bit_exact_vs_cute_matmul": exact,
                      "simulated_cycles": r.cycles,
                      "cycles_equal_pricing": r.cycles == priced,
                      "span_violations": len(bad_spans)}
        require(by_tile == reckoned and launched == sum(by_tile.values()),
                f"plan exec {name}: K1 ran "
                f"{by_tile} by tile, reckoned {reckoned}")
        require(exact, f"plan exec {name}: a GEMM differs from cute_matmul")
        require(r.cycles == priced and not bad_spans,
                f"plan exec {name}: cycles {r.cycles} against {priced}, "
                f"span violations {bad_spans}")
        outs[name] = r.outputs
        for t_, n in by_tile.items():
            total[t_] = total.get(t_, 0) + n
        del r
    same = all(torch.equal(outs["desim"][k], outs["desim-cluster"][k])
               for k in ops)
    require(same and list(outs["desim"]) == list(ops),
            "plan exec: desim and desim-cluster give different numbers")
    del outs, ops

    # the front door: launch.serve --plan desim --metrics-out
    metrics_path = ROOT / "build" / "smoke_plan_metrics.json"
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    fused_matmul.launches_by_tile = dict.fromkeys(total, 0)
    flash_attention.launches_by_tile = dict.fromkeys(
        flash_attention.launches_by_tile, 0)
    raw, launch_s = run_launcher(PLAN_LAUNCH_ARGV
                                 + ["--metrics-out", str(metrics_path)])
    k1_launch = dict(fused_matmul.launches_by_tile)
    k2_launch = dict(flash_attention.launches_by_tile)
    served = re.search(r"served (\d+) requests, (\d+) tokens on (\S+) "
                       r"in ([0-9.]+)s", raw)
    lines = launcher_text(raw)
    want = REFERENCE["launcher"]["plan"]
    snap = json.loads(metrics_path.read_text())
    plans = sum(row["value"]
                for row in snap["counters"].get("serving_plans_total", []))
    emit({"phase": "plan", "config": f"{ARCH} full width and depth "
          f"({cfg.n_layers} layers), planning only; prompts "
          f"{list(PLAN_PROMPTS)}, arrival gap {PLAN_ARRIVAL_GAP:.0f} cycles",
          "sweep": sweep, "sweep_host_s": sweep_s,
          "serve_traffic": {"prompts": list(serve_prompts()),
                            "sweep": serve_sweep,
                            "sweep_host_s": serve_sweep_s},
          "exec": runs,
          "exec_backends_equal": same,
          "launcher": {"argv": PLAN_LAUNCH_ARGV, "host_s": launch_s,
                       "lines_equal_reference": lines == want,
                       "served": served.group(0) if served else None,
                       "fused_matmul_by_tile": k1_launch,
                       "flash_attention_by_tile": k2_launch,
                       "by_tile_reckoned": launcher_reckoned,
                       "metrics_plans_total": plans},
          "note": "cycles are simulated cycles of the paper's CPU matrix "
                  "unit (2 GHz), not card time"})
    require(lines == want, "plan: the launcher's plan lines differ from "
            f"the reference's: {lines} against {want}")
    require(served is not None and served.group(1) == "6"
            and served.group(3) == "cuda" and plans >= 1,
            "plan: the launcher did not serve its 6 requests on the card "
            "or wrote no plan counter")
    require(k1_launch == launcher_reckoned["fused_matmul"]
            and k2_launch == launcher_reckoned["flash_attention"],
            f"plan: the launcher's serving ran K1 {k1_launch}, K2 "
            f"{k2_launch}, reckoned {launcher_reckoned}")
    for t_, n in k1_launch.items():
        total[t_] += n
    torch.cuda.empty_cache()
    return {"fused_matmul": sum(total.values()),
            "fused_matmul_by_tile": total,
            "flash_attention": sum(k2_launch.values()),
            "flash_attention_by_tile": k2_launch}


def phase_tune(cfg):
    """The tuning package held to the reference on the card's machine:
    the full-space autotune of each platform regenerates its shipped
    cache byte for byte, and ``measure_decode_regime`` of each platform
    equals the reference's (``REFERENCE["tune"]``, recorded by
    ``scripts/record_smoke_constants.py``).  Then yi-6b at full width and
    depth: the launcher's traffic (``PLAN_PROMPTS``, all arriving at 0)
    planned with ``tuned=True`` on ``TUNE_UNITS`` units under
    ``TUNE_POLICY`` and run with ``example_operands`` through
    ``run_schedule(tuned=True)``, which builds its backend with
    ``get_tuned("desim-cluster")``: the tuned lowering (the cache's
    granularity), one K1 launch a matrix node, by tile as reckoned from
    the graph; every GEMM equal to one ``cute_matmul`` bit for bit; its
    cycles the reference's pricing of the same tuned schedule and its
    span log valid.  Cycles are simulated cycles of the paper's CPU
    matrix unit, not card time."""
    from repro_torch import backend, tune
    from repro_torch.core.fusion import cute_matmul
    from repro_torch.core.hardware import PLATFORMS
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.serving.scheduler import backend_kwargs_for
    from repro_torch.tune import autotune, regime
    ref = REFERENCE["tune"]
    t0 = time.perf_counter()
    caches = {plat: tune.dump_cache(plat, autotune.autotune_platform(plat))
              .encode() == tune.cache_path(plat).read_bytes()
              for plat in sorted(PLATFORMS)}
    autotune_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    regimes = {plat: regime.measure_decode_regime(plat)
               for plat in sorted(PLATFORMS)}
    regime_s = time.perf_counter() - t0

    eng = plan_engine(cfg, PLAN_PROMPTS, gap=0.0)
    sched = eng.plan(MAX_NEW, units=TUNE_UNITS, policy=TUNE_POLICY,
                     tuned=True)
    tuned = backend.tuned_config(sched=sched)
    be = backend.get_tuned("desim-cluster", sched=sched,
                           **backend_kwargs_for(sched, units=sched.units))
    graph = be.partition(be.lower(sched)).graph
    reckoned = _reckon_tiles(graph)
    ops = sched.example_operands(0, "cuda")
    torch.cuda.synchronize()
    fused_matmul.launches = 0
    fused_matmul.launches_by_tile = dict.fromkeys(reckoned, 0)
    t0 = time.perf_counter()
    r = eng.run_schedule(sched, "desim-cluster", operands=ops,
                         workload=False, tuned=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_tile = dict(fused_matmul.launches_by_tile)
    launched = fused_matmul.launches
    exact = all(torch.equal(r.outputs[label],
                            cute_matmul(a, b, backend="kernel"))
                for label, (a, b) in ops.items())
    bad_spans = r.detail["span_log"].validate()
    got = {"bucket": tune.schedule_bucket(sched),
           "config": None if tuned is None else tuned.to_dict(),
           "policy": sched.policy, "overlap": sched.overlap,
           "units": sched.units, "steps": len(sched.steps),
           "graph_cycles": r.cycles}
    emit({"phase": "tune", "caches_regenerated": caches,
          "autotune_host_s": autotune_s,
          "regime_equal_reference": {p_: regimes[p_] == ref["regime"][p_]
                                     for p_ in regimes},
          "regime": {p_: {k: m[k] for k in ("tuned", "untuned", "speedup",
                                             "tuned_speedup",
                                             "fusion_speedup")}
                     for p_, m in regimes.items()},
          "regime_host_s": regime_s,
          "config": f"{ARCH} full width and depth ({cfg.n_layers} layers), "
                    f"planning only; prompts {list(PLAN_PROMPTS)} arriving "
                    f"at 0, {TUNE_UNITS} units, {TUNE_POLICY}, tuned",
          "schedule": got, "schedule_equal_reference": got == ref["sched"],
          "backend": {"granularity": be.granularity.value,
                      "fused": be.fused, "units": be.units},
          "matmul_nodes": graph.stats()["matmul"],
          "fused_matmul_by_tile": by_tile,
          "fused_matmul_by_tile_reckoned": reckoned,
          "bit_exact_vs_cute_matmul": exact, "run_schedule_s": wall,
          "span_violations": len(bad_spans),
          "note": "cycles are simulated cycles of the paper's CPU matrix "
                  "unit (2 GHz), not card time"})
    require(all(caches.values()), f"tune: a regenerated cache differs from "
            f"the shipped one: {caches}")
    require(regimes == ref["regime"], "tune: measure_decode_regime differs "
            f"from the reference's: {regimes} against {ref['regime']}")
    require(got == ref["sched"], f"tune: the tuned schedule {got} differs "
            f"from the reference's {ref['sched']}")
    require(by_tile == reckoned and launched == sum(by_tile.values()),
            f"tune: K1 ran {by_tile} by tile, reckoned {reckoned}")
    require(exact, "tune: a GEMM differs from cute_matmul")
    require(not bad_spans, f"tune: span violations {bad_spans}")
    del r, ops
    torch.cuda.empty_cache()
    return {"fused_matmul": launched, "fused_matmul_by_tile": by_tile}


def phase_online(cfg):
    """The online closed loop on yi-6b at full width (``ONLINE_ENGINE``:
    chunked prefill, a hot KV pool small enough to evict and refill),
    ``ONLINE_REQUESTS`` seeded Poisson arrivals at ``ONLINE_QPS``: its
    ``OnlineResult.summary()`` (TTFT/ITL percentiles, goodput, epochs,
    preemptions), the KV cache's counters and trace digest and the span
    log's digest must equal the reference's, and the span log must
    validate; then ``launch.serve.main`` with ``--qps`` once, its online
    lines against the reference launcher's.  Host only: it proves the
    front door runs on the card's machine, not the card's speed."""
    from repro_torch.serving.arrivals import PoissonArrivals, qps_to_gap
    from repro_torch.serving.online import OnlineServingEngine
    t0 = time.perf_counter()
    eng = OnlineServingEngine(cfg, **ONLINE_ENGINE)
    res = eng.run(PoissonArrivals(mean_gap=qps_to_gap(ONLINE_QPS,
                                                      eng.freq_hz),
                                  n=ONLINE_REQUESTS, seed=0))
    loop_s = time.perf_counter() - t0
    got = {"summary": res.summary(), "kv": eng.kv_cache.counters,
           "kv_digest": eng.kv_cache.trace_digest(),
           "span_digest": span_digest(res.span_log),
           "span_violations": res.span_log.validate()}
    raw, launch_s = run_launcher(ONLINE_LAUNCH_ARGV)
    lines = launcher_text(raw)
    want = REFERENCE["launcher"]["online"]
    emit({"phase": "online", "config": f"{ARCH} full width and depth, "
          f"{ONLINE_REQUESTS} Poisson arrivals at {ONLINE_QPS:.0f} req/s "
          f"(seed 0), {ONLINE_ENGINE}", **got,
          "equal_reference": got == REFERENCE["online"],
          "loop_host_s": loop_s,
          "launcher": {"argv": ONLINE_LAUNCH_ARGV, "host_s": launch_s,
                       "lines_equal_reference": lines == want},
          "note": "cycles are simulated cycles of the paper's CPU matrix "
                  "unit; the loop runs on the host"})
    require(got == REFERENCE["online"], f"online: {got} differs from the "
            f"reference's {REFERENCE['online']}")
    require(res.n_preemptions > 0 and got["kv"]["refills"] > 0,
            "online: no request was preempted or no KV block refilled")
    require(lines == want, "online: the launcher's online lines differ "
            f"from the reference's: {lines} against {want}")


# ---------------------------------------------------------------------------
# Where a prefill's and a decode step's device time goes (torch.profiler).
# ---------------------------------------------------------------------------

def _device_ms_by_kernel(prof, n):
    """(device kernel events, busy ms per call, ms per call by kernel
    group, K1's, K2's and K4's ms per call by tile) of a trace of ``n``
    calls."""
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / n
    groups = dict.fromkeys([*KERNEL_TAGS, "other"], 0.0)
    tiles = {g: dict.fromkeys(tags, 0.0) for g, tags in TILE_TAGS.items()}
    for e in device:
        g = next((name for name, tag in KERNEL_TAGS.items() if tag in e.key),
                 "other")
        groups[g] += e.self_device_time_total / 1e3 / n
        if g in tiles:
            tile = next(t for t, tags in TILE_TAGS[g].items()
                        if any(tag in e.key for tag in tags))
            tiles[g][tile] += e.self_device_time_total / 1e3 / n
    return device, busy, groups, tiles


def k1_host_us():
    """Host microseconds a K1 call takes on each tile, at a shape whose
    device time is a few microseconds and that ``select_tile`` sends to
    that tile (fp32 for the SIMT tile): 200 calls enqueued back to back,
    timed on the host's clock to a synchronize.  The tensor-core tile's
    figure includes encoding its two tensor maps; ``wrapper_decode`` is
    the decode call through the wrapper (``ops.fused_matmul``), which adds
    the reshapes and the operand checks."""
    from repro_torch.core.fusion import Epilogue, EpilogueOperands
    from repro_torch.kernels.matmul.matmul import fused_matmul_cuda, tile_for
    from repro_torch.kernels.matmul.ops import fused_matmul
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for tile, m, dtype in (("tc", 16, torch.bfloat16),
                           ("simt", 16, torch.float32),
                           ("decode", MAX_BATCH, torch.bfloat16)):
        a = _rand(gen, (m, 64), dtype)
        b = _rand(gen, (64, 64), dtype)
        ep, ops = Epilogue(out_dtype=dtype), EpilogueOperands()
        require(tile_for(a, b, ep) == tile,
                f"host-time case for {tile} runs on {tile_for(a, b, ep)}")
        for _ in range(20):
            fused_matmul_cuda(a, b, ep, ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fused_matmul_cuda(a, b, ep, ops)
        torch.cuda.synchronize()
        out[tile] = (time.perf_counter() - t0) * 1e6 / 200
    t0 = time.perf_counter()
    for _ in range(200):
        fused_matmul(a, b)                 # the wrapper on top, decode tile
    torch.cuda.synchronize()
    out["wrapper_decode"] = (time.perf_counter() - t0) * 1e6 / 200
    return out


def phase_profile(arch, phase, s_max, host_cost=False):
    """Device time by kernel of the prefill of the serving batch (4
    requests at the longest batch's prompt length) and over
    ``PROFILE_STEPS`` decode steps after it, and the device's idle share
    of an untraced step (the mean of ``UNTRACED_STEPS``).  With tied
    embeddings, the time of the transposed copy of the embedding that
    the logits take.  Measures only: it fails no run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.models.base import family_module
    cfg = get_config(arch)
    mod = family_module(cfg)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MAX_BATCH, s_max))).cuda()
    cache = mod.init_cache(cfg, MAX_BATCH, CACHE_LEN, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        logits, cache = mod.prefill(cfg, params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
    _, prefill_busy, prefill_groups, prefill_tiles = _device_ms_by_kernel(
        prof, 1)
    pos = s_max

    def steps(n):
        nonlocal logits, cache, pos
        for _ in range(n):
            logits, cache = mod.decode_step(cfg, params,
                                            logits.argmax(-1)[:, None],
                                            cache, pos)
            pos += 1
        torch.cuda.synchronize()

    steps(1)                                           # warm
    t0 = time.perf_counter()
    steps(UNTRACED_STEPS)
    step_ms = (time.perf_counter() - t0) * 1e3 / UNTRACED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(PROFILE_STEPS)
        traced_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    device, busy, groups, tiles = _device_ms_by_kernel(prof, PROFILE_STEPS)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    line = {"phase": phase, "config": f"{arch} full size, bf16, prefill of "
            f"({MAX_BATCH},{s_max}), then decode at batch {MAX_BATCH} from "
            f"position {s_max}", "steps": PROFILE_STEPS,
            "prefill_device_ms": prefill_busy,
            "prefill_device_ms_by_kernel": prefill_groups,
            **{f"prefill_{g}_ms_by_tile": t
               for g, t in prefill_tiles.items() if any(t.values())},
            "prefill_device_share_by_kernel": {
                g: ms / prefill_busy for g, ms in prefill_groups.items()
                if ms > 0} if prefill_busy else {},
            "decode_step_ms": step_ms, "traced_step_ms": traced_ms,
            "profiler_saw_device": bool(device),
            "device_busy_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / step_ms,
            "device_ms_per_step_by_kernel": groups,
            **{f"{g}_ms_per_step_by_tile": t
               for g, t in tiles.items() if any(t.values())},
            "top_device_kernels": [
                {"name": e.key[:160], "launches_per_step":
                 e.count / PROFILE_STEPS,
                 "ms_per_step": e.self_device_time_total / 1e3
                 / PROFILE_STEPS}
                for e in top]}
    if host_cost:
        line["fused_matmul_host_us_per_call"] = k1_host_us()
    if cfg.tie_embeddings:
        emb = params["embedding"]
        line["tied_embedding_copy_ms"] = time_ms(
            {"copy": lambda: emb.T.contiguous()})["copy"]
        line["tied_embedding_copy_bytes"] = 2 * emb.numel() * \
            emb.element_size()
    emit(line)
    del params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# yi-6b's MLP at full width through the W8A8 layers.
# ---------------------------------------------------------------------------

def phase_w8a8(cfg, s_max):
    import torch.nn.functional as F
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.quant.ops import quantize_rowwise
    from repro_torch.kernels.quant.ref import quantize_rowwise_ref
    from repro_torch.serving.quantized import quantize_mlp
    d, ff, rows = cfg.d_model, cfg.d_ff, MAX_BATCH * s_max
    gen = torch.Generator(device="cuda").manual_seed(5)
    wi = torch.randn(d, 2 * ff, generator=gen, device="cuda") / d ** 0.5
    wo = torch.randn(ff, d, generator=gen, device="cuda") / ff ** 0.5
    x = torch.randn(rows, d, generator=gen, device="cuda")
    lin_in, lin_out = quantize_mlp(wi, wo, x)

    def mlp(route):
        h = lin_in(x, out_dtype=torch.float32, backend=route)
        g = F.silu(h[:, :ff]) * h[:, ff:]
        return g, lin_out(g, out_dtype=torch.float32, backend=route)

    counters = {"quantize_rowwise": quantize_rowwise,
                "fused_matmul": fused_matmul}
    for fn in counters.values():
        fn.launches = 0
    g_kern, y_kern = mlp("kernel")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    _, y_plain = mlp("torch")
    # the int8 activations of both layers, kernel against plain, on the
    # same inputs
    acts = [x / lin_in.smooth, g_kern / lin_out.smooth]
    same = [bool(torch.equal(a, b) and torch.equal(sa, sb))
            for (a, sa), (b, sb) in ((quantize_rowwise(t),
                                      quantize_rowwise_ref(t))
                                     for t in acts)]
    h = x @ wi
    y_float = (F.silu(h[:, :ff]) * h[:, ff:]) @ wo
    torch.cuda.synchronize()
    rel_routes, diff_routes = rel_err(y_kern, y_plain)
    rel_float, _ = rel_err(y_kern, y_float)
    finite = bool(torch.isfinite(y_kern).all())
    emit({"phase": "w8a8", "config": f"{ARCH} MLP at full width: wi "
          f"({d},{2 * ff}), wo ({ff},{d}), calibrated and run on x "
          f"({rows},{d}), fp32 out", "launches": launches,
          "int8_activations_identical": same,
          "rel_err_vs_plain_route": rel_routes,
          "max_abs_err_vs_plain_route": diff_routes,
          "tol_vs_plain_route": TOL_W8A8_ROUTES,
          "rel_err_vs_float_mlp": rel_float,
          "tol_vs_float_mlp": TOL_W8A8_FLOAT, "finite": finite})
    require(finite and all(same) and rel_routes <= TOL_W8A8_ROUTES
            and rel_float <= TOL_W8A8_FLOAT,
            "the W8A8 MLP disagrees with its plain route or the float MLP")
    require(all(v > 0 for v in launches.values()),
            f"w8a8: a kernel of the path never launched: {launches}")
    del wi, wo, lin_in, lin_out
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Training: yi-6b at full width takes AdamW steps through K1 and its
# autograd Function.
# ---------------------------------------------------------------------------

def _train_k1_calls(cfg, chunks: int) -> int:
    """K1's launches in one microbatch's forward and backward of ``cfg``
    (``tests/test_torch_training.py::
    test_chip_smoke_reckons_k1_calls_of_every_family`` counts the same on
    the CPU, family by family): each projection once in the forward, once
    more where remat "full" reruns its layer group ("dots" keeps K1's
    outputs; Griffin's tail blocks run outside remat), and one
    accumulator recompute in the backward of each projection whose
    epilogue is not linear in the accumulator (an activation, GLU or not,
    or a softcap; a bias is linear); the loss's logits 2 a chunk (the
    forward and its per-chunk remat), 3 with a final softcap.  MoE's
    experts and router, RWKV-6's LoRA second factors and the recurrences
    run as plain ops on the torch route."""
    rerun = 2 if cfg.remat == "full" else 1

    def group(fwd, nonlinear, remat=True):
        return fwd * (rerun if remat else 1) + nonlinear

    if cfg.family == "rwkv6":
        # time mix: mix_w1, r, k, v, g (silu), decay_w1, o; channel mix:
        # k (relu2), v, r
        per = cfg.n_layers * group(10, 2)
    elif cfg.family == "griffin":
        # rec: gate in (gelu_tanh), rnn in, input and recurrence gates
        # (row bias), out; attn: q, k, v, o; each with its MLP
        blocks = {"rec": (5 + 2, 1 + 1), "attn": (4 + 2, 1)}
        pat = cfg.rnn.block_pattern
        n_groups = cfg.n_layers // len(pat)
        tail = pat[:cfg.n_layers - n_groups * len(pat)]
        per = (n_groups * group(sum(blocks[k][0] for k in pat),
                                sum(blocks[k][1] for k in pat))
               + sum(group(*blocks[k], remat=False) for k in tail))
    elif cfg.family == "encdec":
        # encoder: q, k, v, o, MLP; decoder: self q, k, v, o, cross q, k,
        # v (from the encoder's output), o, MLP
        per = (cfg.encdec.n_encoder_layers * group(4 + 2, 1)
               + cfg.n_layers * group(4 + 4 + 2, 1))
    elif cfg.moe is None or cfg.moe.dense_parallel:
        # attention q, k, v, o; the MLP's wi (an activation) and wo, or
        # Arctic's dense branch beside its experts
        per = cfg.n_layers * group(4 + 2, 1)
    else:
        per = cfg.n_layers * group(4, 0)      # attention only
    return per + (3 if cfg.final_softcap else 2) * chunks


def _cut(arch, n_layers, **over):
    """``arch``'s full configuration, cut to ``n_layers`` (None: whole)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch).with_(**over)
    return cfg if n_layers is None else cfg.with_(n_layers=n_layers)


def _grad_rel(mu, ref):
    """{leaf path: max |g - r| / max |r|} of two first moments."""
    from repro_torch.core import tree
    return {tree.path_str(path): rel_err(g, r)[0]
            for (path, g), r in zip(tree.flatten_with_path(mu),
                                    tree.leaves(ref))}


@contextlib.contextmanager
def exact_products():
    """The torch matmul route with every product of ``linear`` taken in
    fp64 and rounded once to its accumulator's dtype (autograd
    differentiates the fp64 product, so the backward's are exact too).
    Yields a one-item list counting the products so taken."""
    from repro_torch.core import fusion
    plain, taken = fusion.plain_matmul, [0]

    def exact(a, b, accum_dtype):
        taken[0] += 1
        return torch.matmul(a.double(), b.double()).to(accum_dtype)
    fusion.plain_matmul = exact
    try:
        yield taken
    finally:
        fusion.plain_matmul = plain


def phase_train_parity():
    """At full width in fp32 (TF32 off), one ``make_train_step`` on a
    ``SyntheticLM`` batch (2 x 256; Whisper's with seeded audio frames)
    through each matmul route: the kernel route (K1 and its autograd op,
    SIMT tile in fp32) against the torch route, for
    yi-6b (2 layers) and each other trained family at the smallest depth
    that holds every block kind (TRAIN_PARITY_FAMILIES).  The step's loss
    within TOL_TRAIN_LOSS relative; its gradients, read from the
    optimizer's first moment after the step (from zero, (1 - beta1) x the
    clipped gradient, in fp32), within TOL_TRAIN_GRAD of each leaf's max
    |g|, or, leaf by leaf, no further from a third step's, the torch
    route with exact products (``exact_products``), than TOL_TRAIN_GRAD
    or than the torch route lies from it; K1's launches by tile as
    reckoned (``_train_k1_calls``).  The updated parameters are
    not compared: Adam's first step moves each by lr on its gradient's
    sign alone, so a gradient near 0 moves its parameter by 2 lr on a
    rounding.  Attention, experts and recurrences on the plain torch
    route, as the launcher trains them.  Then yi-6b at remat "dots" on
    the kernel route: its gradients equal remat "none"'s bit for bit, K1
    7 launches a layer and microbatch (6 forward, the GLU backward's
    accumulator; the recompute launches none, its outputs kept) and 2 a
    loss chunk."""
    from repro_torch import backend
    from repro_torch.core import tree
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.training import train_step as ts
    b, s = TRAIN_PARITY_BATCH
    tcfg = ts.TrainConfig(optimizer=adamw.AdamWConfig(
        lr=3e-3, warmup_steps=1, total_steps=6), loss_chunk=min(512, s))
    tiles = tuple(fused_matmul.launches_by_tile)
    by_tile = dict.fromkeys(tiles, 0)

    def count(ran):
        for t, n in ran.items():
            by_tile[t] += n

    cases = ((ARCH, TRAIN_PARITY_LAYERS),) + TRAIN_PARITY_FAMILIES
    for arch, layers in cases:
        cfg = _cut(arch, layers, dtype=torch.float32,
                   kv_cache_dtype=torch.float32, backend="torch")
        params = family_module(cfg).init(
            cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
        batch = train_batch(cfg, b, s, "cuda", seed=5)
        reckoned = {"tc": 0, "decode": 0,
                    "simt": _train_k1_calls(cfg, -(-s // tcfg.loss_chunk))}
        out = {}
        for route in ("kernel", "torch", "exact"):
            prev = backend.set_default_matmul_backend(
                "kernel" if route == "kernel" else "torch")
            try:
                with (exact_products() if route == "exact"
                      else contextlib.nullcontext([None])) as taken:
                    p = tree.tree_map(torch.clone, params)
                    opt = adamw.init(tcfg.optimizer, p)
                    fused_matmul.launches_by_tile = dict.fromkeys(tiles, 0)
                    _, opt, metrics, _ = ts.make_train_step(cfg, tcfg)(
                        p, opt, batch)
                    torch.cuda.synchronize()
                out[route] = (float(metrics["loss"]), opt["mu"],
                              dict(fused_matmul.launches_by_tile),
                              float(metrics["grad_norm"]), taken[0])
                del p
            finally:
                backend.set_default_matmul_backend(prev)
        k, t, x = out["kernel"], out["torch"], out["exact"]
        loss_rel = abs(k[0] - t[0]) / abs(t[0])
        grad_rel = _grad_rel(k[1], t[1])
        # the leaves past TOL_TRAIN_GRAD: (kernel to torch, kernel to
        # exact, torch to exact)
        k_x, t_x = _grad_rel(k[1], x[1]), _grad_rel(t[1], x[1])
        past = {leaf: (rel, k_x[leaf], t_x[leaf])
                for leaf, rel in grad_rel.items() if rel > TOL_TRAIN_GRAD}
        grads_ok = all(kx <= max(TOL_TRAIN_GRAD, tx)
                       for _, kx, tx in past.values())
        finite = all(bool(torch.isfinite(g).all())
                     for g in tree.leaves(k[1]))
        emit({"phase": "train-parity", "arch": arch,
              "config": f"{arch} full width, {cfg.n_layers} layers"
                        + (f" ({cfg.encdec.n_encoder_layers} encoder)"
                           if cfg.encdec else "")
                        + f", fp32, remat {cfg.remat}, batch {b} x {s}, "
                          "one step",
              "loss": {"kernel": k[0], "torch": t[0], "rel": loss_rel},
              "grad_norm": {"kernel": k[3], "torch": t[3]},
              "grad_rel_max": max(grad_rel.values()),
              "grad_rel_by_leaf": grad_rel,
              "grad_rel_to_exact_max": {"kernel": max(k_x.values()),
                                        "torch": max(t_x.values())},
              "past_tol_grad": past, "exact_products": x[4],
              "loss_exact": x[0],
              "tol_loss": TOL_TRAIN_LOSS, "tol_grad": TOL_TRAIN_GRAD,
              "fused_matmul_by_tile": k[2],
              "fused_matmul_by_tile_reckoned": reckoned,
              "fused_matmul_by_tile_torch_route": t[2], "finite": finite})
        require(finite and loss_rel <= TOL_TRAIN_LOSS and grads_ok
                and x[4] > 0,
                f"train-parity {arch}: the kernel route's loss or gradients "
                "disagree with the torch route's and the exact step's")
        require(k[2] == reckoned and sum(t[2].values()) == 0
                and sum(x[2].values()) == 0,
                f"train-parity {arch}: K1 ran {k[2]}, reckoned {reckoned}; "
                f"the torch route {t[2]}")
        count(k[2])
        del params, out, k, t, x
        torch.cuda.empty_cache()

    # remat "dots" against "none", yi-6b on the kernel route
    grads = {}
    for remat in ("none", "dots"):
        cfg = _cut(ARCH, TRAIN_PARITY_LAYERS, dtype=torch.float32,
                   kv_cache_dtype=torch.float32, backend="torch",
                   remat=remat)
        params = family_module(cfg).init(
            cfg, torch.Generator(device="cuda").manual_seed(5), "cuda")
        batch = train_batch(cfg, b, s, "cuda", seed=5)
        fused_matmul.launches_by_tile = dict.fromkeys(tiles, 0)
        loss, _, g = ts.value_and_grad(cfg, tcfg, params, batch)
        torch.cuda.synchronize()
        grads[remat] = (loss, tree.leaves(g),
                        dict(fused_matmul.launches_by_tile))
        del params, g
    reckoned = {"tc": 0, "decode": 0,
                "simt": _train_k1_calls(cfg, -(-s // tcfg.loss_chunk))}
    (l0, g0, ran0), (l1, g1, ran) = grads["none"], grads["dots"]
    count(ran0)
    same = bool(torch.equal(l0, l1)) and all(
        torch.equal(x, y) for x, y in zip(g0, g1))
    emit({"phase": "train-parity", "arch": ARCH,
          "config": f"{ARCH} full width, {cfg.n_layers} layers, fp32, remat "
                    f"dots against none, batch {b} x {s}, the kernel route",
          "loss": {"dots": float(l1), "none": float(l0)},
          "bit_for_bit": same, "fused_matmul_by_tile": ran,
          "fused_matmul_by_tile_reckoned": reckoned,
          "k1_a_layer": (ran["simt"] - 2 * -(-s // tcfg.loss_chunk))
          / cfg.n_layers})
    require(same, "train-parity: remat 'dots' changed the gradients of "
            "remat 'none'")
    require(ran == reckoned, f"train-parity dots: K1 ran {ran}, reckoned "
            f"{reckoned}")
    count(ran)
    del grads, g0, g1
    torch.cuda.empty_cache()
    return {"fused_matmul": sum(by_tile.values()),
            "fused_matmul_by_tile": by_tile}


def _train_memory_reckoned(cfg, n_params: int, rows: int, seq: int) -> dict:
    """Bytes a train step of ``cfg`` (bf16, remat "full", microbatches of
    ``rows`` rows, sequences of ``seq``; one loss chunk) holds at its
    peak, the larger of two moments:

    * ``loss``, the backward of the loss chunk, before any gradient of
      the microbatch exists: the state (bf16 params; fp32 master, mu and
      nu) and the fp32 accumulator of the microbatches, 18 B a
      parameter, and five fp32 (rows, vocab) blocks live at once (the
      logits recomputed, logsumexp's and the gather's gradients and
      their sum, K1's output; one more with a softcap, for the
      accumulator K1 recomputes) beside an fp32 (d, vocab) copy of the
      output weight (the meta trace's composition at that moment, with
      storages tracked by ``core.hlo_cost``);
    * ``layer``, the backward of the first layer group, every other
      gradient of the microbatch in place (bf16, 2 B a parameter; 20 in
      all), and the group's largest transient: for the dense MLP the fp32
      accumulator and its gradient (2 x rows x 2 d_ff x 4), the fp32
      copy of wi and its fp32 gradient (2 x d x 2 d_ff x 4), the stacked
      bf16 gradient one layer's slice fills (L x d x 2 d_ff x 2) and the
      group inputs remat keeps (L x rows x d x 2); for MoE the stacked
      bf16 gradient of the experts' wi and the fp32 copies of one layer's
      expert weights the plain einsums hold (E x d x 3 d_ff_expert x 4);
      for RWKV-6 the chunked WKV's two saved fp32 (b, h, chunk, chunk,
      head) blocks a chunk, rows x d x 64 x 4 each over the sequence, and
      the stacked bf16 gradient of the channel mix's key weight.

    The loss moment's blocks were read off the meta trace of these steps
    (``core.hlo_cost``, storages tracked), after a first form that
    counted yi-6b's blocks for every family: the reckoning is calibrated
    on that trace, not predicted, and TOL_TRAIN_MEMORY holds the card's
    peak to it."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    state = n_params * (2 + 4 + 4 + 4)
    blocks = 5 + (1 if cfg.final_softcap else 0)
    loss = state + n_params * 4 + blocks * rows * V * 4 + d * V * 4
    if cfg.moe is not None:
        m = cfg.moe
        glu = 2 if cfg.mlp_glu else 1
        transient = (L * m.n_experts * d * glu * m.d_ff_expert * 2
                     + m.n_experts * d * (glu + 1) * m.d_ff_expert * 4)
    elif cfg.family == "rwkv6":
        transient = (2 * rows * d * 64 * 4
                     + L * d * cfg.d_ff * 2)
    else:
        n2 = 2 * cfg.d_ff
        transient = (2 * rows * n2 * 4 + 2 * d * n2 * 4 + L * d * n2 * 2
                     + L * rows * d * 2)
    layer = state + n_params * (4 + 2) + transient
    out = {"state": state, "loss_moment": loss, "layer_moment": layer,
           "total": max(loss, layer)}
    return out


def phase_train(card):
    """yi-6b at full width (d 4096, 32/4 heads of 128, d_ff 11008, vocab
    64000) cut to TRAIN_LAYERS layers, bf16 with fp32 master weights,
    remat "full", driven through ``launch/train.py::train`` with
    TRAIN_ARGV into a checkpoint directory under build/: 6 AdamW steps of
    2 microbatches of 4 x 512 tokens (2,048 rows a K1 call), a checkpoint
    at step 4.  Then a second run with the same arguments restores step 4
    into fresh state and takes steps 5-6; its losses must match the first
    run's within TOL_RESUME relative (the embedding's backward may
    accumulate in another order).  One checkpoint, not one every 3 steps:
    each holds 26.7 GB, and the script keeps its disk writes under 45 GiB
    (three checkpoints write 80 GB).  The loss must be finite and lower at
    step 6 than at step 1, K1's launches by tile as reckoned, the peak
    memory within TOL_TRAIN_MEMORY of the reckoning.  The same 6 steps on
    the torch matmul route (no checkpoint) must give the kernel route's
    losses within TOL_TRAIN_ROUTES relative at every step.  Both routes
    run again at TRAIN_LR_WITNESS, the launcher's default rate, as a
    witness that there the loss is not lower at step 6 than at step 1 on
    the route without K1 either (the optimiser's doing, not the
    kernel's); after the loss's jump at step 4 the two routes part by
    more than rounding (4e-2 on an H100), so they are reported, not held
    to each other."""
    import argparse
    import shutil
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.launch import train as launch_train
    from repro_torch.training.train_step import TrainConfig, abstract_state
    cfg = get_config(ARCH).with_(n_layers=TRAIN_LAYERS)
    tiles = tuple(fused_matmul.launches_by_tile)
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = launch_train.parse_args(TRAIN_ARGV + ["--ckpt-dir", str(ckpt),
                                                 "--device", "cuda"])
    rows = args.global_batch // args.microbatches * args.seq_len
    n_params = sum(x.numel() for x in
                   tree.leaves(abstract_state(cfg, TrainConfig())[0]))
    per_step = args.microbatches * _train_k1_calls(cfg, 1)

    def run(route, steps, **over):
        """``steps`` launcher steps on matmul route ``route``, with
        ``over`` in place of TRAIN_ARGV's arguments."""
        run_args = argparse.Namespace(**{**vars(args), **over})
        fused_matmul.launches = flash_attention.launches = 0
        fused_matmul.launches_by_tile = dict.fromkeys(tiles, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prev = backend.set_default_matmul_backend(route)
        try:
            t0 = time.perf_counter()
            res = launch_train.train(cfg, run_args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            backend.set_default_matmul_backend(prev)
        info = {"route": route, "lr": run_args.lr, "start": res.start,
                "losses": res.losses, "step_ms_device": res.step_ms_device,
                "step_s_host": res.step_seconds, "wall_s": wall,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "fused_matmul_by_tile": dict(fused_matmul.launches_by_tile),
                "fused_matmul_by_tile_reckoned": {
                    "tc": steps * per_step if route == "kernel" else 0,
                    "decode": 0, "simt": 0},
                "flash_attention": flash_attention.launches}
        del res
        torch.cuda.empty_cache()
        return info

    def routes_rel(kern, plain):
        return [abs(a - b) / abs(b)
                for a, b in zip(kern["losses"], plain["losses"])]

    try:
        full = run("kernel", args.steps)
        resumed = run("kernel", args.steps - args.ckpt_every)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch_route = run("torch", args.steps, ckpt_dir=None)
    witness = {route: run(route, args.steps, ckpt_dir=None,
                          lr=TRAIN_LR_WITNESS)
               for route in ("kernel", "torch")}
    losses = full["losses"]
    step_ms = statistics.median(full["step_ms_device"][1:])
    tokens = args.global_batch * args.seq_len
    mem = _train_memory_reckoned(cfg, n_params, rows, args.seq_len)
    mem_rel = full["max_memory_allocated"] / mem["total"] - 1.0
    resume_rel = [abs(a - b) / abs(b) for a, b in
                  zip(resumed["losses"], losses[args.ckpt_every:])]
    route_rel = routes_rel(full, torch_route)
    witness_rel = routes_rel(witness["kernel"], witness["torch"])
    runs = (full, resumed, torch_route, *witness.values())
    finite = all(bool(np.isfinite(r["losses"]).all()) for r in runs)
    emit({"phase": "train", "nvidia_smi": card,
          "config": f"{ARCH} full width, {cfg.n_layers} of 32 layers, bf16 "
                    f"with fp32 master, remat {cfg.remat}",
          "argv": TRAIN_ARGV, "params": n_params, "rows_a_k1_call": rows,
          "full": full, "resumed": resumed, "resume_rel": resume_rel,
          "tol_resume": TOL_RESUME,
          "torch_route": torch_route, "route_rel": route_rel,
          "witness_lr": TRAIN_LR_WITNESS, "witness": witness,
          "witness_route_rel": witness_rel, "tol_routes": TOL_TRAIN_ROUTES,
          "step_ms_median_2_6": step_ms,
          "tokens_per_s": tokens / (step_ms / 1e3),
          "memory_reckoned": mem, "memory_rel": mem_rel,
          "tol_memory": TOL_TRAIN_MEMORY})
    require(finite and losses[-1] < losses[0],
            f"train: losses {losses} not finite or not falling")
    require(resumed["start"] == args.ckpt_every
            and len(resumed["losses"]) == args.steps - args.ckpt_every
            and max(resume_rel) <= TOL_RESUME,
            f"train: the resumed run's losses {resumed['losses']} differ "
            f"from the uninterrupted run's {losses[args.ckpt_every:]}")
    require(max(route_rel) <= TOL_TRAIN_ROUTES,
            f"train: the kernel route's losses differ from the torch "
            f"route's by {route_rel}")
    require(witness["torch"]["losses"][-1] >= witness["torch"]["losses"][0],
            f"train: at lr {TRAIN_LR_WITNESS} the torch route's loss falls "
            f"({witness['torch']['losses']}): the phase's lower rate needs "
            f"another reason")
    for r in runs:
        require(r["fused_matmul_by_tile"] == r["fused_matmul_by_tile_reckoned"]
                and r["flash_attention"] == 0,
                f"train: K1 ran {r['fused_matmul_by_tile']} on the "
                f"{r['route']} route, reckoned "
                f"{r['fused_matmul_by_tile_reckoned']}; K2 "
                f"{r['flash_attention']}")
    require(abs(mem_rel) <= TOL_TRAIN_MEMORY,
            f"train: peak {full['max_memory_allocated']} B against "
            f"{mem['total']} B reckoned")
    by_tile = {t: sum(r["fused_matmul_by_tile"][t] for r in runs)
               for t in tiles}
    for t, n in _train_families(card, args).items():
        by_tile[t] += n
    return {"fused_matmul": sum(by_tile.values()),
            "fused_matmul_by_tile": by_tile}


def _train_direct(cfg, args):
    """The launcher's loop without its stream, for an encoder-decoder
    model: ``args.steps`` steps of ``make_train_step`` under the
    launcher's TrainConfig on ``train_batch``'s batches (the stream's,
    with seeded audio frames), CUDA events around each step.  Returns
    the launcher's ``TrainResult``."""
    from repro_torch.core.precision import disable_tf32
    from repro_torch.launch.train import TrainResult
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainConfig, make_train_step
    disable_tf32()
    cfg = cfg.with_(backend="torch")
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                    warmup_steps=max(args.steps // 20, 1)),
        microbatches=args.microbatches, loss_chunk=min(512, args.seq_len))
    step_fn = make_train_step(cfg, tcfg)
    params = family_module(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = adamw.init(tcfg.optimizer, params)
    losses, seconds, device_ms = [], [], []
    for step in range(args.steps):
        t0 = time.perf_counter()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        batch = train_batch(cfg, args.global_batch, args.seq_len, "cuda",
                            step=step)
        params, opt, metrics, _ = step_fn(params, opt, batch)
        ev1.record()
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
        device_ms.append(ev0.elapsed_time(ev1))
        print(f"step {step:5d} loss {losses[-1]:.4f} "
              f"{seconds[-1] * 1e3:.0f}ms", flush=True)
    return TrainResult(params, opt, 0, losses, seconds, device_ms)


def _train_families(card, args):
    """OLMoE-1B-7B, RecurrentGemma-2B and RWKV-6-7B at full width, each
    at its TRAIN_FAMILY_LAYERS depth, bf16 with fp32 master weights,
    remat "full", through ``launch/train.py::train`` with TRAIN_ARGV's
    batch (2 microbatches of 4 x 512 tokens) for TRAIN_FAMILY_STEPS
    steps, no checkpoint; Whisper-tiny at full size through
    ``make_train_step`` (``_train_direct``), since the launcher's stream
    has no audio frames.  Each on the kernel matmul route, then on the
    torch route: the losses finite and lower at the last step than at the
    first, the routes' losses within TOL_TRAIN_ROUTES relative at every
    step, K1's launches by tile as reckoned (``_train_k1_calls``: all on
    the tensor-core tile; none on the torch route) and K2 none, the
    kernel route's peak memory within TOL_TRAIN_MEMORY of its reckoning.
    Returns K1's launches by tile."""
    import argparse
    from repro_torch import backend
    from repro_torch.core import tree
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.launch import train as launch_train
    from repro_torch.training.train_step import TrainConfig, abstract_state
    tiles = tuple(fused_matmul.launches_by_tile)
    by_tile = dict.fromkeys(tiles, 0)
    rows = args.global_batch // args.microbatches * args.seq_len
    tokens = args.global_batch * args.seq_len
    for arch, layers in TRAIN_FAMILY_LAYERS.items():
        fam_args = argparse.Namespace(**{
            **vars(args), "ckpt_dir": None, "steps": TRAIN_FAMILY_STEPS,
            "lr": TRAIN_FAMILY_LR.get(arch, args.lr)})
        cfg = _cut(arch, layers)
        n_params = sum(x.numel() for x in
                       tree.leaves(abstract_state(cfg, TrainConfig())[0]))
        per_step = args.microbatches * _train_k1_calls(cfg, 1)
        runs = {}
        for route in ("kernel", "torch"):
            fused_matmul.launches = flash_attention.launches = 0
            fused_matmul.launches_by_tile = dict.fromkeys(tiles, 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            prev = backend.set_default_matmul_backend(route)
            try:
                t0 = time.perf_counter()
                res = (_train_direct(cfg, fam_args) if cfg.encdec
                       else launch_train.train(cfg, fam_args))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                backend.set_default_matmul_backend(prev)
            runs[route] = {
                "route": route, "losses": res.losses,
                "step_ms_device": res.step_ms_device,
                "step_s_host": res.step_seconds, "wall_s": wall,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "fused_matmul_by_tile": dict(fused_matmul.launches_by_tile),
                "fused_matmul_by_tile_reckoned": {
                    "tc": (TRAIN_FAMILY_STEPS * per_step
                           if route == "kernel" else 0),
                    "decode": 0, "simt": 0},
                "flash_attention": flash_attention.launches}
            del res
            torch.cuda.empty_cache()
        kern, plain = runs["kernel"], runs["torch"]
        losses = kern["losses"]
        step_ms = statistics.median(kern["step_ms_device"][1:])
        mem = _train_memory_reckoned(cfg, n_params, rows, args.seq_len)
        mem_rel = kern["max_memory_allocated"] / mem["total"] - 1.0
        route_rel = [abs(a - b) / abs(b)
                     for a, b in zip(kern["losses"], plain["losses"])]
        finite = all(bool(np.isfinite(r["losses"]).all())
                     for r in runs.values())
        emit({"phase": "train", "arch": arch, "nvidia_smi": card,
              "config": f"{arch} full width, {cfg.n_layers} layers"
                        + (f" + {cfg.encdec.n_encoder_layers} encoder"
                           if cfg.encdec else "")
                        + ", bf16 with fp32 master, remat "
                        f"{cfg.remat}", "params": n_params,
              "batch": f"{args.global_batch} x {args.seq_len}, "
                       f"{args.microbatches} microbatches",
              "lr": fam_args.lr,
              "rows_a_k1_call": rows, "kernel_route": kern,
              "torch_route": plain, "route_rel": route_rel,
              "tol_routes": TOL_TRAIN_ROUTES,
              "step_ms_median_2_4": step_ms,
              "tokens_per_s": tokens / (step_ms / 1e3),
              "memory_reckoned": mem, "memory_rel": mem_rel,
              "tol_memory": TOL_TRAIN_MEMORY})
        require(finite and losses[-1] < losses[0],
                f"train {arch}: losses {losses} not finite or not falling")
        require(max(route_rel) <= TOL_TRAIN_ROUTES,
                f"train {arch}: the kernel route's losses differ from the "
                f"torch route's by {route_rel}")
        for r in runs.values():
            require(r["fused_matmul_by_tile"]
                    == r["fused_matmul_by_tile_reckoned"]
                    and r["flash_attention"] == 0,
                    f"train {arch}: K1 ran {r['fused_matmul_by_tile']} on "
                    f"the {r['route']} route, reckoned "
                    f"{r['fused_matmul_by_tile_reckoned']}; K2 "
                    f"{r['flash_attention']}")
        require(abs(mem_rel) <= TOL_TRAIN_MEMORY,
                f"train {arch}: peak {kern['max_memory_allocated']} B "
                f"against {mem['total']} B reckoned")
        for t, n in kern["fused_matmul_by_tile"].items():
            by_tile[t] += n
    return by_tile


# ---------------------------------------------------------------------------
# Distributed execution: ranks spawned on the card (one a card where the
# machine has one for each), through launch.mesh.run_world.
# ---------------------------------------------------------------------------

def _counted(wrappers: dict):
    """Set each wrapper's launch counts to 0; returns the function that
    reads them: {name: launches, f"{name}_by_tile": {tile: launches}}."""
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_tile"):        # K5 has one tile
            fn.launches_by_tile = dict.fromkeys(fn.launches_by_tile, 0)

    def read():
        out = {}
        for name, fn in wrappers.items():
            out[name] = fn.launches
            if hasattr(fn, "launches_by_tile"):
                out[f"{name}_by_tile"] = dict(fn.launches_by_tile)
        return out
    return read


def _moe_wrappers():
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    return {"fused_matmul": fused_matmul, "flash_attention": flash_attention,
            "grouped_matmul": grouped_matmul}


def _dist_ep_configs():
    """(tag, config) of ``dist-ep``'s two cases: OLMoE-1B-7B at full
    width, 4 layers in fp32, then full depth in bf16."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(MOE_ARCH)
    return (("fp32", cfg.with_(n_layers=DIST_EP_FP32_LAYERS,
                               dtype=torch.float32,
                               kv_cache_dtype=torch.float32)),
            ("bf16", cfg))


def _serve_traffic(cfg, params):
    """The serve traffic (``prompt_lengths``, batch 4, 16 new tokens,
    greedy) through ``ServingEngine.run``: (tokens (8, 16), each batch's
    prefill logits in fp32, the engine's per-batch results, every router
    call's expert indices on the CPU)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.base import family_module
    from repro_torch.serving.engine import ServingEngine
    mod = family_module(cfg)
    inner, inner_route, logits, picks = mod.prefill, moe_lib.route, [], []

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        logits.append(out[0].float())
        return out

    def routing(rcfg, x2d, w_router):
        gate, idx = inner_route(rcfg, x2d, w_router)
        picks.append(idx.sort(dim=-1).values.cpu())
        return gate, idx
    lengths, rng = prompt_lengths()
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH,
                        cache_len=CACHE_LEN)
    for n in lengths:
        eng.submit(torch.from_numpy(rng.integers(0, cfg.vocab_size, n)))
    mod.prefill, moe_lib.route = recording, routing
    try:
        outs = eng.run(max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
    finally:
        mod.prefill, moe_lib.route = inner, inner_route
    return torch.stack(outs), logits, eng.results, picks


def _exec_step_graphs(s_max):
    """yi-6b's int8 prefill and decode steps at full width, lowered by the
    kernel backend as phase ``exec`` lowers them, with exec's operands
    (its generator, drawn in its order): [(graph, {label: (a, b)})]."""
    from repro_torch import backend
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.engine import _step_layer
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(6)
    kern = backend.get("kernel")
    out = []
    for step, tokens in (("prefill", MAX_BATCH * s_max),
                         ("decode", MAX_BATCH)):
        layer = _step_layer(cfg, step, tokens, cfg.n_layers)
        ops = _operands(gen, {f"{step}/g{i}": (t.m, t.k, t.n)
                              for i, t in enumerate(layer.gemms)},
                        torch.int8)
        out.append((kern.lower([layer]), ops))
    return out


def _compress_grads(rank: int) -> dict:
    """``dist-compress``'s gradient tree of ``rank``, seeded by rank."""
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED + 100 + rank)
    return {name: torch.randn(shape, generator=gen, device="cuda")
            for name, shape in DIST_COMPRESS_SHAPES.items()}


def _events_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` calls after one
    warm-up; a collective's host waits fall inside the window."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _dist_rank(world, out_dir: str, s_max: int, reckoned: dict) -> None:
    """One rank of phase ``dist``, spawned by ``run_world``.  Prints one
    line a check (its rank, the world, the backend, the collectives staged
    through the host, launches by tile, errors against their limits, ms
    from CUDA events), raises on a failed check (which fails the world),
    and writes its launch counts to ``out_dir/rank{r}.json``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree
    from repro_torch.core.fusion import linear
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import collectives, logical, sharding
    from repro_torch.distributed.collective_matmul import (
        allgather_matmul_reference, collective_matmul)
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.base import family_module
    from repro_torch.optim.compression import compress_tree, psum_compressed
    global _EMIT_LOCK
    disable_tf32()
    out_dir, r, n = Path(out_dir), world.rank, world.size
    _EMIT_LOCK = out_dir / "emit.lock"
    one = torch.load(out_dir / "one_rank.pt")
    head = {"rank": r, "world": n, "backend": world.backend,
            "backend_reason": world.reason, "device": str(world.device)}
    k1 = {"fused_matmul": fused_matmul}
    launches = {}

    def staged():
        """The collectives staged through the host since the last call."""
        out = dict(collectives.STAGED)
        collectives.STAGED.clear()
        return out

    def line(phase, counts, staged_ops, **kw):
        emit({"phase": phase, **head, "staged_through_host": staged_ops,
              **(counts or {}), **kw})
        if counts is not None:
            launches[phase] = counts

    # dist-ep: OLMoE served expert-parallel on a (data 1, model n) mesh
    mesh = make_mesh((1, n), ("data", "model"))
    for tag, cfg in _dist_ep_configs():
        gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
        torch.cuda.reset_peak_memory_stats()
        whole = family_module(cfg).init(cfg, gen, "cuda")
        params = sharding.shard_params(whole, mesh,
                                       sharding.EXPERT_PARALLEL_RULES,
                                       glu=cfg.mlp_glu)
        n_whole = sum(x.numel() for x in tree.leaves(whole))
        del whole
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()
        held = sum(x.numel() * x.element_size() for x in tree.leaves(params))
        experts_held = params["layers"][0]["moe"]["experts_wi"].shape[1]
        cache = family_module(cfg).init_cache(cfg, MAX_BATCH, CACHE_LEN,
                                              device="meta")
        cache_bytes = sum(x.numel() * x.element_size()
                          for x in tree.leaves(cache))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        read = _counted(_moe_wrappers())
        # fp32: all experts at once; bf16: the shards in turn (the
        # ranks' arithmetic), with all experts at once reported
        ref = one[f"ep-{tag}"]
        target = one.get(f"ep-{tag}-shards", ref)
        staged()
        with logical.use_rules(mesh, sharding.EXPERT_PARALLEL_RULES):
            tokens, logits, results, picks = _serve_traffic(cfg, params)
        counts, staged_ops = read(), staged()
        peak = torch.cuda.max_memory_allocated()

        def against(r):
            return dict(
                prefill_logits_rel_err=[rel_err(x.cpu(), y)[0] for x, y in
                                        zip(logits, r["logits"])],
                prefill_logits_bit_identical=all(
                    torch.equal(x.cpu(), y)
                    for x, y in zip(logits, r["logits"])),
                greedy_tokens_agree=float(
                    (tokens.cpu() == r["tokens"]).float().mean()),
                expert_choices_differing=sum(
                    int((a != b).any(-1).sum())
                    for a, b in zip(picks, r["picks"])))
        vs = against(target)
        errs, agree = vs["prefill_logits_rel_err"], vs["greedy_tokens_agree"]
        tol = TOL_DIST_EP_FP32 if tag == "fp32" else TOL_PATH_BF16
        same_counts = all(counts[k] == ref["counts"][k] for k in counts)
        reckoning = {"weights_held": held, "kv_cache": cache_bytes,
                     "total": held + cache_bytes}
        line("dist-ep" if tag == "bf16" else "dist-ep-fp32", counts,
             staged_ops,
             config=f"{MOE_ARCH} full width, {cfg.n_layers} layers, "
                    f"{str(cfg.dtype)[6:]}, {experts_held} of "
                    f"{cfg.moe.n_experts} experts a rank",
             params_whole=n_whole,
             held_against=("one rank, all experts at once" if target is ref
                           else f"one rank, the {n} shards in turn"),
             **vs, tol=tol,
             expert_choices=sum(int(i.shape[0]) for i in picks),
             vs_all_experts_at_once=(None if target is ref else against(ref)),
             prefill_ms=[x.prefill_ms() for x in results],
             decode_step_ms=[x.decode_step_ms() for x in results],
             one_rank_prefill_ms=ref["prefill_ms"],
             one_rank_decode_step_ms=ref["decode_step_ms"],
             max_memory_allocated_init=init_peak,
             max_memory_allocated=peak, memory_reckoned=reckoning,
             launches_equal_one_rank=same_counts)
        require(experts_held * n == cfg.moe.n_experts,
                f"dist-ep {tag}: a rank holds {experts_held} experts")
        require(all(e <= tol for e in errs) and all(
            bool(torch.isfinite(x).all()) for x in logits),
            f"dist-ep {tag}: prefill logits {errs} against {tol}")
        require(agree == 1.0,
                f"dist-ep {tag}: greedy tokens differ from one rank's")
        require(tag == "fp32" or vs["prefill_logits_bit_identical"],
                f"dist-ep {tag}: prefill logits differ from the shards' in "
                "turn on one rank")
        require(same_counts, f"dist-ep {tag}: launches {counts}, one rank "
                f"{ref['counts']}")
        for name, by_tile in reckoned.items() if tag == "bf16" else ():
            require(counts[f"{name}_by_tile"] == by_tile,
                    f"dist-ep: {name} ran {counts[f'{name}_by_tile']} by "
                    f"tile, reckoned {by_tile}")
        require(peak <= reckoning["total"] * (1 + TOL_DIST_MEMORY),
                f"dist-ep {tag}: peak {peak} B against "
                f"{reckoning['total']} B reckoned")
        del params, results, logits, picks
        torch.cuda.empty_cache()

    # dist-cmm: collective matmul at yi-6b's logits shape, then int8
    cm_mesh = make_mesh((n,), ("model",))
    idx = cm_mesh.index("model")
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED + 1)
    yi = get_config(ARCH)
    rows, d, vocab = MAX_BATCH * s_max, yi.d_model, yi.padded_vocab
    cases = {}
    for tag, (k_, n_, dt) in (("bf16", (d, vocab, torch.bfloat16)),
                              ("int8", (d, d, torch.int8))):
        x = _rand(gen, (rows, k_), dt)
        w = _rand(gen, (k_, n_), dt)
        if dt.is_floating_point:
            w = (w.float() / k_ ** 0.5).to(dt)
        read = _counted(k1)
        staged()
        y = collective_matmul(x, w, cm_mesh).to_local()
        torch.cuda.synchronize()
        counts, staged_ops = read(), staged()
        cols = n_ // n
        ref = allgather_matmul_reference(x, w[:, idx * cols:(idx + 1) * cols])
        rel, diff = rel_err(y, ref)
        cases[tag] = dict(
            shape=f"{str(dt)[6:]} ({rows},{k_})@({k_},{n_}): rows of x "
                  f"and columns of w over {n} ranks",
            rel_err=rel, max_abs_err=diff, exact=bool(torch.equal(y, ref)),
            tol=0.0 if tag == "int8" else TOL_BF16, counts=counts,
            staged_through_host=staged_ops,
            ms=_events_ms(lambda: collective_matmul(x, w, cm_mesh)))
        require(tuple(y.shape) == (rows, cols) and rel <= cases[tag]["tol"]
                and (tag != "int8" or cases[tag]["exact"]),
                f"dist-cmm {tag}: {rel} against {cases[tag]['tol']}")
        require(counts["fused_matmul"] == n,
                f"dist-cmm {tag}: {counts['fused_matmul']} K1 launches, "
                f"expected {n}")
        del x, w, y, ref
    launches["dist-cmm"] = {
        "fused_matmul": sum(c["counts"]["fused_matmul"]
                            for c in cases.values()),
        "fused_matmul_by_tile": {t: sum(c["counts"]["fused_matmul_by_tile"]
                                        [t] for c in cases.values())
                                 for t in fused_matmul.launches_by_tile}}
    emit({"phase": "dist-cmm", **head, "cases": cases})

    # dist-pipe: GPipe over n stages of PIPE_LAYERS tanh layers, K1 each
    pp_mesh = make_mesh((n,), ("pp",))
    width = PIPE_WIDTH
    ws = (_rand(gen, (n * PIPE_LAYERS, width, width), torch.float32)
          / width ** 0.5).to(torch.bfloat16)
    xs = _rand(gen, (PIPE_MICRO, PIPE_ROWS, width), torch.bfloat16)

    def block_fn(stage_params, x, backend=None):
        for w_ in stage_params:
            x = linear(x, w_, activation="tanh", backend=backend)
        return x
    read = _counted(k1)
    staged()
    out = pipeline_apply(block_fn, ws, xs, pp_mesh)
    torch.cuda.synchronize()
    counts, staged_ops = read(), staged()
    # the plain version: the same layers in turn on the torch route
    seq = torch.stack([block_fn(ws, xs[i], "torch")
                       for i in range(PIPE_MICRO)])
    rel, diff = rel_err(out, seq)
    steps = PIPE_MICRO + n - 1
    line("dist-pipe", counts, staged_ops,
         shape=f"{n} stages x {PIPE_LAYERS} layers of linear(x, W, tanh), "
               f"bf16 W ({width},{width}), {PIPE_MICRO} microbatches of "
               f"{PIPE_ROWS} rows",
         rel_err_vs_plain_sequential=rel, max_abs_err=diff, tol=TOL_BF16,
         ms=_events_ms(lambda: pipeline_apply(block_fn, ws, xs, pp_mesh)))
    require(rel <= TOL_BF16, f"dist-pipe: {rel} against {TOL_BF16}")
    require(counts["fused_matmul"] == steps * PIPE_LAYERS,
            f"dist-pipe: {counts['fused_matmul']} K1 launches, expected "
            f"{steps * PIPE_LAYERS}")
    del ws, xs, out, seq

    # dist-sharded: yi-6b's int8 serving step through backend "sharded"
    from repro_torch import backend
    graphs = _exec_step_graphs(s_max)
    ref = torch.load(out_dir / "sharded_ref.pt")
    sh = backend.get("sharded", units=n, strategy="output-tile")
    read = _counted(k1)
    staged()
    t0 = time.perf_counter()
    outs = {}
    for graph, ops in graphs:
        outs.update(sh.run_graph(graph, ops).outputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, staged_ops = read(), staged()
    exact = (set(outs) == set(ref) and all(
        torch.equal(outs[k].cpu(), ref[k]) for k in ref))
    line("dist-sharded", counts, staged_ops,
         graphs=f"{ARCH} int8 prefill ({MAX_BATCH} x {s_max} tokens) and "
                f"decode ({MAX_BATCH} tokens) steps, output-tile over the "
                "ranks", bit_exact_vs_kernel_backend=exact,
         run_graph_s=wall, ms=_events_ms(lambda: [
             sh.run_graph(graph, ops) for graph, ops in graphs], reps=3))
    require(exact, "dist-sharded: outputs differ from the kernel backend's")
    require(counts["fused_matmul"] == len(ref),
            f"dist-sharded: {counts['fused_matmul']} K1 launches, one a "
            f"GEMM expected ({len(ref)})")
    del graphs, ref, outs

    # dist-compress: int8 payloads all-reduced, against one rank's sum
    residual = {k: torch.zeros(s, device="cuda")
                for k, s in DIST_COMPRESS_SHAPES.items()}
    staged()
    avg, new_res = psum_compressed(_compress_grads(r), residual)
    torch.cuda.synchronize()
    staged_ops = staged()
    packed = [compress_tree(_compress_grads(i), residual) for i in range(n)]
    _, scale, res = packed[r]
    expect = {k: sum(q[k].to(torch.int32) for q, _, _ in packed).to(
        torch.float32) * scale[k] / n for k in DIST_COMPRESS_SHAPES}
    exact = all(torch.equal(avg[k], expect[k])
                and torch.equal(new_res[k], res[k])
                for k in DIST_COMPRESS_SHAPES)
    grads = _compress_grads(r)
    line("dist-compress", None, staged_ops,
         shapes={k: list(s) for k, s in DIST_COMPRESS_SHAPES.items()},
         bit_exact_vs_one_rank=exact,
         ms=_events_ms(lambda: psum_compressed(grads, residual)))
    require(exact, "dist-compress: the sum differs from one rank's")
    (out_dir / f"rank{r}.json").write_text(json.dumps(
        {"world": head, "launches": launches}))


def phase_dist(s_max, reckoned):
    """Distributed execution on the card, ``DIST_RANKS`` ranks spawned
    through ``launch.mesh.run_world`` (gloo when they share the card, NCCL
    when each has one).  First, in this process, the references: the
    serve traffic through OLMoE-1B-7B on one rank (4 layers fp32, then
    full depth bf16; launches by tile as ``reckoned``; bf16 once more
    under an abstract (data 1, model 2) mesh, the shards in turn), and
    yi-6b's int8
    serving step through ``backend.get("kernel")`` and through
    ``backend.get("sharded")`` with its spans as a loop (bit for bit).
    Then the ranks (``_dist_rank``): dist-ep, dist-cmm, dist-pipe,
    dist-sharded and dist-compress.  A rank that fails, or a world that
    outlives ``DIST_TIMEOUT``, fails the phase (the other ranks are
    ended).  Writes no checkpoint."""
    import shutil

    from repro_torch import backend
    from repro_torch.distributed import logical
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.launch.mesh import abstract_mesh, run_world
    from repro_torch.models.base import family_module
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    one, launches = {}, {}
    for tag, cfg in _dist_ep_configs():
        gen = torch.Generator(device="cuda").manual_seed(DIST_SEED)
        params = family_module(cfg).init(cfg, gen, "cuda")
        read = _counted(_moe_wrappers())
        tokens, logits, results, picks = _serve_traffic(cfg, params)
        counts = read()
        one[f"ep-{tag}"] = {
            "tokens": tokens.cpu(), "logits": [x.cpu() for x in logits],
            "picks": picks,
            "prefill_ms": [x.prefill_ms() for x in results],
            "decode_step_ms": [x.decode_step_ms() for x in results],
            "counts": counts}
        if tag == "bf16":
            for name, by_tile in reckoned.items():
                require(counts[f"{name}_by_tile"] == by_tile,
                        f"dist one rank: {name} ran "
                        f"{counts[f'{name}_by_tile']} by tile, reckoned "
                        f"{by_tile}")
            with logical.use_rules(abstract_mesh((1, DIST_RANKS),
                                                 ("data", "model"))):
                tokens, logits, _, picks = _serve_traffic(cfg, params)
            # each shard routes the same tokens: one routing a layer
            one["ep-bf16-shards"] = {
                "tokens": tokens.cpu(), "logits": [x.cpu() for x in logits],
                "picks": picks[::DIST_RANKS]}
        del params, results, logits, picks
        torch.cuda.empty_cache()
    graphs = _exec_step_graphs(s_max)
    kern = backend.get("kernel")
    sh = backend.get("sharded", units=DIST_RANKS, strategy="output-tile")
    ref, loop = {}, {}
    for graph, ops in graphs:
        ref.update(kern.run_graph(graph, ops).outputs)
    read = _counted({"fused_matmul": fused_matmul})
    t0 = time.perf_counter()
    for graph, ops in graphs:
        loop.update(sh.run_graph(graph, ops).outputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read()
    exact = set(loop) == set(ref) and all(torch.equal(loop[k], ref[k])
                                          for k in ref)
    emit({"phase": "dist-sharded", "rank": None, "world": 1,
          "spans": f"a loop in one process over {DIST_RANKS} units",
          **counts, "bit_exact_vs_kernel_backend": exact,
          "run_graph_s": wall})
    require(exact, "dist-sharded (one process): outputs differ from the "
            "kernel backend's")
    require(counts["fused_matmul"] == DIST_RANKS * len(ref),
            f"dist-sharded (one process): {counts['fused_matmul']} K1 "
            f"launches, expected {DIST_RANKS * len(ref)}")
    launches["dist-sharded/one-process"] = counts
    torch.save(one, DIST_DIR / "one_rank.pt")
    torch.save({k: v.cpu() for k, v in ref.items()},
               DIST_DIR / "sharded_ref.pt")
    del graphs, ref, loop, one
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    try:
        run_world(_dist_rank, DIST_RANKS, (str(DIST_DIR), s_max, reckoned),
                  rendezvous=str(DIST_DIR / "rendezvous"),
                  timeout=DIST_TIMEOUT)
    except Exception as e:                   # a rank failed or hung
        raise PhaseFailed(f"dist: {type(e).__name__}: {e}") from None
    world_s = time.perf_counter() - t0
    ranks = [json.loads((DIST_DIR / f"rank{i}.json").read_text())
             for i in range(DIST_RANKS)]
    for i, got in enumerate(ranks):
        for path, counts in got["launches"].items():
            launches[f"{path}/rank{i}"] = counts
    emit({"phase": "dist", "ranks": DIST_RANKS,
          "backend": ranks[0]["world"]["backend"],
          "backend_reason": ranks[0]["world"]["backend_reason"],
          "devices": [got["world"]["device"] for got in ranks],
          "world_wall_s": world_s,
          "wall_s": time.perf_counter() - t_phase, "launches": launches})
    for f in DIST_DIR.iterdir():            # dist-seq reads mesh_one.pt
        if f.is_dir():
            shutil.rmtree(f)
        elif f.name != "mesh_one.pt":
            f.unlink()
    return launches


# ---------------------------------------------------------------------------
# Training and serving on a mesh: tensor parallelism, FSDP, data parallelism.
# ---------------------------------------------------------------------------

def _mesh_tp_configs():
    """(tag, config) of ``dist-tp``'s two cases: yi-6b at full width,
    DIST_TP_FP32_LAYERS in fp32, then full depth in bf16."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    return (("fp32", cfg.with_(n_layers=DIST_TP_FP32_LAYERS,
                               dtype=torch.float32,
                               kv_cache_dtype=torch.float32)),
            ("bf16", cfg))


def _mesh_train_fp32():
    """(config, TrainConfig) of ``dist-train-fp32``: yi-6b at full width,
    DIST_TRAIN_FP32_LAYERS, fp32, remat "full", the plain torch route with
    K1 for the projections, one AdamW step."""
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainConfig
    cfg = _cut(ARCH, DIST_TRAIN_FP32_LAYERS, dtype=torch.float32,
               backend="torch")
    return cfg, TrainConfig(
        optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        loss_chunk=DIST_TRAIN_FP32_BATCH[1])


def _mesh_serve(cfg, params, cache, follow=None, rows=None, batch=None,
                steps=DIST_TP_DECODE):
    """The serve traffic's first batch (4 prompts padded to 221 tokens,
    with seeded stub-frontend inputs where the model has a frontend)
    through ``serving.engine.make_prefill`` and ``steps`` steps of
    ``make_decode``, CUDA events around each: {logits (fp32, on the CPU,
    one a step), greedy (the argmax of each, (4, steps + 1)), prefill_ms,
    decode_ms, cache (as the steps left it), batch (the prefill's)}.
    The decode steps feed ``follow``'s tokens where given (the one-rank
    run's, all 4 rows), else the run's own greedy ones.  ``rows``: the
    slice of the batch this process serves (a data rank's), all 4 where
    None.  ``batch``: the whole batch to serve instead of the traffic's."""
    from repro_torch.serving.engine import make_decode, make_prefill
    if batch is None:
        lengths, rng = prompt_lengths()
        s = int(max(lengths[:MAX_BATCH]))
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
            MAX_BATCH, s))).to(device="cuda", dtype=torch.int32)
        batch = {"tokens": tokens, **stub_inputs(
            cfg, MAX_BATCH, torch.Generator(device="cuda").manual_seed(
                DIST_SEED))}
    s = batch["tokens"].shape[1]
    if rows is not None:
        batch = {k: x[rows] for k, x in batch.items()}
        follow = follow[rows] if follow is not None else None
    prefill, decode = make_prefill(cfg), make_decode(cfg)

    def timed(fn, *args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    (logits, cache), prefill_ms = timed(prefill, params, batch, cache)
    out, decode_ms = [logits.float().cpu()], []
    for i in range(steps):
        nxt = (follow[:, i] if follow is not None
               else out[-1].argmax(-1)).to("cuda", torch.int32)
        (logits, cache), ms = timed(decode, params, nxt[:, None], cache,
                                    s + i)
        out.append(logits.float().cpu())
        decode_ms.append(ms)
    return {"logits": out,
            "greedy": torch.stack([x.argmax(-1) for x in out], 1),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "cache": cache, "batch": batch}


def _mesh_train_collectives(cfg, sizes: dict, rows: int, seq: int,
                            microbatches: int, grad_bytes: int) -> dict:
    """Collective bytes by kind of one train step of a dense model with an
    untied output weight and pre-norms only (yi-6b) on one rank of a
    mesh of ``sizes``, under the default rules, remat "full", ``rows``
    rows a microbatch on the rank, one loss chunk of ``seq`` a row, the
    replicated leaves' gradients of ``grad_bytes`` a value (4 where
    microbatches accumulate in fp32).  Where the q heads do not divide the
    model axis, q is gathered over it (every head on every rank); where
    the rank's KV heads are not those its q heads read, the KV weights
    are.  ``tests/test_torch_tensor_parallel.py`` holds it to the meta
    count.  A microbatch:

    * all-gather: a layer's weights over data, whole in d (wq, wk, wv,
      wo, wi and the MLP's wo, each with its model shard), and over model
      q (rows x seq x q_dim) and the KV weights where gathered, in the
      forward and again in remat's recompute; the embedding and the
      output weight once;
    * reduce-scatter: each of those once in the backward, to its shard;
    * all-reduce: an activation (rows x seq x d, fp32: the partial
      products' sum) at each of a layer's two region exits in the
      forward, the attention's in the recompute (which stops at the last
      tensor the backward needs, before the MLP's exit); one in the
      model's dtype at each of its two entries in the backward, the
      embedding's sum and the loss's entry in the backward; the loss
      chunk's row max, sum of exponentials and label logit (fp32) in the
      forward and in its recompute; the token count over the batch axes.

    A step: each norm scale's gradient over the data axes, and over the
    pod axis every leaf's; the loss (and with one microbatch its nll and
    z) over the batch axes; the clipping norm over every axis."""
    from repro_torch.core import tree
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import rank_view
    from repro_torch.models.base import family_module
    d, q, kv, ff, v, n = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                          cfg.padded_vocab, cfg.n_layers)
    e = torch.finfo(cfg.dtype).bits // 8
    m, data = sizes.get("model", 1), sizes.get("data", 1)
    batch_axes = [a for a in ("pod", "data") if sizes.get(a, 1) > 1]
    act = rows * seq * d * e
    group = cfg.n_heads // cfg.n_kv_heads
    gather_q = m > 1 and cfg.n_heads % m != 0
    hq = cfg.n_heads if gather_q else cfg.n_heads // m
    own_kv = (cfg.n_kv_heads % m == 0 and hq % group == 0
              and hq // group == cfg.n_kv_heads // m)
    fsdp = (d * q + 2 * d * kv + q * d + d * 2 * ff + ff * d) // m * e
    fsdp = fsdp if data > 1 else 0
    model = ((rows * seq * q if gather_q else 0)
             + (2 * d * kv if m > 1 and not own_kv else 0)) * e
    vocab = v // m * d * e if data > 1 else 0
    gather = n * 2 * (fsdp + model) + 2 * vocab
    scatter = n * (fsdp // data + model // m) + 2 * vocab // data
    reduce = 4 * len(batch_axes)
    if m > 1:
        reduce += (n * (3 * act // e * 4 + 2 * act) + 2 * act
                   + 2 * 3 * rows * seq * 4)
    out = {"all-gather": microbatches * gather,
           "reduce-scatter": microbatches * scatter,
           "all-reduce": microbatches * reduce}
    if sizes.get("data", 1) > 1:
        out["all-reduce"] += (2 * n * d + d) * grad_bytes
    if sizes.get("pod", 1) > 1:
        mesh = rank_view(tuple(sizes.values()), tuple(sizes))
        local = sharding.shard_params(
            family_module(cfg).init(cfg, None, "meta"), mesh,
            glu=cfg.mlp_glu)
        out["all-reduce"] += sum(x.numel() for x in tree.leaves(local)) * (
            grad_bytes if microbatches > 1 else e)
    metrics = 1 if microbatches > 1 else 3
    out["all-reduce"] += (4 * metrics * len(batch_axes)
                          + 4 * sum(1 for s_ in sizes.values() if s_ > 1))
    out = {k: float(x) for k, x in out.items() if x}
    out["total"] = sum(out.values())
    return out


def _dist_mesh_rank(world, out_dir: str) -> None:
    """One rank of phase ``dist-mesh``, spawned by ``run_world``: prints
    the lines dist-tp-fp32, dist-tp (ranks 0 and 1 of a (data 1, model 2)
    mesh), dist-train-fp32, dist-train and dist-dryrun (every rank of
    (data 2, model 2)), raises on a failed check (which fails the world),
    and writes its launch counts to ``out_dir/mesh_rank{r}.json``."""
    from repro_torch.core import hlo_cost, tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import collectives, logical, sharding
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh, rank_view
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import (abstract_state,
                                                 make_train_step)
    global _EMIT_LOCK
    disable_tf32()
    out_dir, r = Path(out_dir), world.rank
    _EMIT_LOCK = out_dir / "emit.lock"
    one = torch.load(out_dir / "mesh_one.pt")
    head = {"rank": r, "world": world.size, "backend": world.backend,
            "backend_reason": world.reason, "device": str(world.device)}
    dense = {"fused_matmul": fused_matmul, "flash_attention": flash_attention}
    launches = {}

    def staged():
        out = dict(collectives.STAGED)
        collectives.STAGED.clear()
        return out

    # dist-tp-fp32, dist-tp: yi-6b's serving steps on (data 1, model 2)
    tp_mesh = make_mesh((1, 2), ("data", "model"))
    for tag, cfg in _mesh_tp_configs() if tp_mesh.has_rank else ():
        mod = family_module(cfg)
        whole = mod.init(cfg, torch.Generator(device="cuda").manual_seed(
            DIST_SEED), "cuda")
        params = sharding.shard_params(whole, tp_mesh, glu=cfg.mlp_glu)
        del whole
        cache = tree.tree_map(
            lambda x: torch.zeros(x.shape, dtype=x.dtype, device="cuda"),
            sharding.shard_cache(mod.init_cache(cfg, MAX_BATCH, CACHE_LEN,
                                                device="meta"),
                                 tp_mesh, cfg))
        torch.cuda.empty_cache()
        ref = one[f"tp-{tag}"]
        read = _counted(dense)
        staged()
        with logical.use_rules(tp_mesh):
            got = _mesh_serve(cfg, params, cache, follow=ref["greedy"][:, :-1])
        counts, staged_ops = read(), staged()
        errs = [rel_err(a, b)[0] for a, b in zip(got["logits"],
                                                 ref["logits"])]
        agree = float((got["greedy"] == ref["greedy"]).float().mean())
        yardstick = {}
        if tag == "bf16":
            # bf16 at full depth: against bf16 rounding's own reach
            # (TOL_TP_BF16), with the distances from fp32 beside it
            fp32 = ref["fp32_logits"]
            ratio = [l2_dist(a, b) / l2_dist(b, c) for a, b, c in
                     zip(got["logits"], ref["logits"], fp32)]
            yardstick = {
                "l2_vs_one_rank_over_one_rank_bf16_vs_fp32": ratio,
                "tol_ratio": TOL_TP_BF16,
                "tp_vs_fp32": [rel_err(a, c)[0]
                               for a, c in zip(got["logits"], fp32)],
                "one_rank_bf16_vs_fp32": [rel_err(b, c)[0] for b, c in
                                          zip(ref["logits"], fp32)]}
        phase = "dist-tp-fp32" if tag == "fp32" else "dist-tp"
        emit({"phase": phase, **head, "staged_through_host": staged_ops,
              **counts,
              "config": f"{ARCH} full width, {cfg.n_layers} layers, "
                        f"{str(cfg.dtype)[6:]}, (data 1, model 2): "
                        f"{cfg.n_heads // 2} q and {cfg.n_kv_heads // 2} KV "
                        "heads a rank",
              "kv_heads_held": cache[0][0].shape[2],
              "logits_rel_err": errs,
              "tol": TOL_PATH if tag == "fp32" else None, **yardstick,
              "greedy_tokens_agree": agree,
              "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
              "one_rank_prefill_ms": ref["prefill_ms"],
              "one_rank_decode_ms": ref["decode_ms"]})
        require(all(bool(torch.isfinite(x).all()) for x in got["logits"]),
                f"{phase}: logits not finite")
        require(tag != "fp32" or all(e_ <= TOL_PATH for e_ in errs),
                f"{phase}: logits {errs} against {TOL_PATH}")
        require(tag != "bf16" or all(
            x <= TOL_TP_BF16 for x in yardstick[
                "l2_vs_one_rank_over_one_rank_bf16_vs_fp32"]),
                f"{phase}: {yardstick} against {TOL_TP_BF16}")
        require(tag != "fp32" or agree == 1.0,
                f"{phase}: greedy tokens differ from one rank's")
        require(counts["fused_matmul"] and counts["flash_attention"],
                f"{phase}: launches {counts}")
        launches[phase] = counts
        del params, cache, got
        torch.cuda.empty_cache()

    # dist-train-fp32: one AdamW step on (data 2, model 2)
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg, tcfg = _mesh_train_fp32()
    whole = family_module(cfg).init(cfg, torch.Generator(
        device="cuda").manual_seed(DIST_SEED), "cuda")
    params = sharding.shard_params(whole, mesh, glu=cfg.mlp_glu)
    del whole
    torch.cuda.empty_cache()
    opt = adamw.init(tcfg.optimizer, params)
    batch = train_batch(cfg, *DIST_TRAIN_FP32_BATCH, "cuda")
    read = _counted(dense)
    with logical.use_rules(mesh):
        _, opt, metrics, _ = make_train_step(cfg, tcfg)(
            params, opt, sharding.local_batch(batch, mesh))
    counts = read()
    ref = one["train-fp32"]
    ref_mu = sharding.shard_params(
        torch.load(out_dir / "mesh_train_mu.pt", mmap=True), mesh,
        glu=cfg.mlp_glu)
    worst = torch.stack([(a - b.cuda()).abs().max().float() for a, b in
                         zip(tree.leaves(opt["mu"]), tree.leaves(ref_mu))])
    collectives.all_reduce(worst, op="max")
    grad_rel = (worst.cpu() / torch.tensor(ref["mu_max"])).tolist()
    loss = float(metrics["loss"])
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    emit({"phase": "dist-train-fp32", **head, **counts,
          "config": f"{ARCH} full width, {cfg.n_layers} layers, fp32, "
                    f"(data 2, model 2), batch {DIST_TRAIN_FP32_BATCH}",
          "loss": loss, "one_rank_loss": ref["loss"], "loss_rel": loss_rel,
          "tol_loss": TOL_TRAIN_LOSS, "mu_rel_max": max(grad_rel),
          "mu_rel_by_leaf": grad_rel, "tol_grad": TOL_TRAIN_GRAD})
    require(loss_rel <= TOL_TRAIN_LOSS,
            f"dist-train-fp32: loss {loss} against one rank's {ref['loss']}")
    require(max(grad_rel) <= TOL_TRAIN_GRAD,
            f"dist-train-fp32: first moment {max(grad_rel)} of a leaf's max")
    launches["dist-train-fp32"] = counts
    del params, opt, ref_mu, metrics
    torch.cuda.empty_cache()

    # dist-train: the launcher on (data 2, model 2)
    args = launch_train.parse_args(DIST_TRAIN_ARGV + ["--device", "cuda"])
    cfg = _cut(ARCH, DIST_TRAIN_LAYERS)
    tcfg = launch_train.train_config(args)
    rows = args.global_batch // args.microbatches // mesh.shape["data"]
    read = _counted(dense)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    staged()
    res = launch_train.train(cfg, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts, staged_ops = read(), staged()

    # dist-dryrun: one more step counted on the card, and on meta at this
    # rank's coordinate
    cfg = cfg.with_(backend="torch")
    step = make_train_step(cfg, tcfg)
    batch = sharding.local_batch(train_batch(
        cfg, args.global_batch, args.seq_len, "cuda", step=args.steps),
        mesh, args.microbatches)
    with logical.use_rules(mesh):
        card, _, card_s = dryrun.count_step(step, (res.params, res.opt_state,
                                                   batch), True)
    view = rank_view(tuple(mesh.shape.values()), mesh.axis_names,
                     mesh.coordinate)
    with logical.use_rules(view):
        meta_params = sharding.shard_params(abstract_state(cfg, tcfg)[0],
                                            view, glu=cfg.mlp_glu)
        meta_args = (meta_params, adamw.init(tcfg.optimizer, meta_params),
                     {k: torch.empty(x.shape, dtype=x.dtype, device="meta")
                      for k, x in batch.items()})
        meta, _, meta_s = dryrun.count_step(step, meta_args, True)
    same, ops_differ = compare_counts(card, meta)
    same_coll = card.per_collective == meta.per_collective
    sizes = dict(mesh.shape)
    reckoned = _mesh_train_collectives(cfg, sizes, rows, args.seq_len,
                                       args.microbatches, 4)
    counted = {**{k: float(x) for k, x in card.per_collective.items()},
               "total": card.collective_bytes}
    mem = {"arguments": dryrun.tree_bytes(meta_args),
           "temp_meta": meta.temp_bytes}
    mem["total"] = mem["arguments"] + mem["temp_meta"]
    k1_reckoned = {"tc": args.steps * args.microbatches
                   * _train_k1_calls(cfg, 1), "decode": 0, "simt": 0}
    one_losses = one["train"]["losses"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(res.losses, one_losses)]
    step_ms = statistics.median(res.step_ms_device[1:])
    emit({"phase": "dist-train", **head, "staged_through_host": staged_ops,
          **counts,
          "config": f"{ARCH} full width, {cfg.n_layers} of 32 layers, bf16 "
                    f"with fp32 master, remat {cfg.remat}, (data 2, model "
                    "2): FSDP over data, tensor parallel over model",
          "argv": DIST_TRAIN_ARGV, "losses": res.losses,
          "one_rank_losses": one_losses, "loss_rel": loss_rel,
          "tol_routes": TOL_TRAIN_ROUTES,
          "step_ms_device": res.step_ms_device,
          "step_ms_median_2_4": step_ms,
          "one_rank_step_ms": one["train"]["step_ms"],
          "tokens_per_s_a_rank": args.global_batch * args.seq_len
          / mesh.size / (step_ms / 1e3),
          "max_memory_allocated": peak, "memory_reckoned": mem,
          "memory_rel": peak / mem["total"] - 1.0,
          "tol_memory": TOL_TRAIN_MEMORY,
          "fused_matmul_by_tile_reckoned": k1_reckoned,
          "collective_bytes_a_step": counted,
          "collective_bytes_reckoned": reckoned})
    emit({"phase": "dist-dryrun", **head,
          "config": f"dist-train's step at {mesh.coordinate} of "
                    f"{mesh.shape}, on the card and on meta (a rank view)",
          "flops": [card.flops, meta.flops], "bytes": [card.bytes, meta.bytes],
          "collective_bytes": [card.per_collective, meta.per_collective],
          "kernels_card": card.kernels, "kernels_meta": meta.kernels,
          "ops_differ": ops_differ, "temp_bytes_meta": meta.temp_bytes,
          "trace_s": {"card": card_s, "meta": meta_s},
          "same": same and same_coll})
    require(all(np.isfinite(res.losses)) and max(loss_rel)
            <= TOL_TRAIN_ROUTES,
            f"dist-train: losses {res.losses} against one rank's "
            f"{one_losses}")
    require(counts["fused_matmul_by_tile"] == k1_reckoned
            and counts["flash_attention"] == 0,
            f"dist-train: K1 ran {counts['fused_matmul_by_tile']}, reckoned "
            f"{k1_reckoned}")
    require(abs(peak / mem["total"] - 1.0) <= TOL_TRAIN_MEMORY,
            f"dist-train: peak {peak} B against {mem['total']} B reckoned")
    require(counted == reckoned, f"dist-train: collective bytes {counted}, "
            f"reckoned {reckoned}")
    require(same and same_coll,
            f"dist-dryrun: the card counted {card.flops} FLOPs, {card.bytes} "
            f"B, {card.per_collective}; meta {meta.flops}, {meta.bytes}, "
            f"{meta.per_collective}")
    launches["dist-train"] = counts
    (out_dir / f"mesh_rank{r}.json").write_text(json.dumps(
        {"world": head, "launches": launches}))


def phase_dist_mesh():
    """Training and serving on a mesh, DIST_MESH_RANKS ranks spawned
    through ``launch.mesh.run_world`` (gloo when they share the card, NCCL
    when each has one).  First, in this process, what the ranks are held
    to, on one rank: yi-6b's serving steps (``_mesh_serve``, fp32 at
    DIST_TP_FP32_LAYERS and bf16 at full depth), one fp32 AdamW step
    (``_mesh_train_fp32``; its first moment saved for the ranks to read)
    and the launcher's run of DIST_TRAIN_ARGV at DIST_TRAIN_LAYERS
    (without a world it is one process).  Then the ranks
    (``_dist_mesh_rank``).  A rank that fails, or a world that outlives
    DIST_MESH_TIMEOUT, fails the phase.  Writes no checkpoint; leaves
    ``mesh_one.pt`` (with the fp32 run's cache) for ``phase_dist_seq``."""
    import shutil

    from repro_torch.core import tree
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import make_train_step
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    one = {}
    for tag, cfg in _mesh_tp_configs() + (
            ("fp32-full", _mesh_tp_configs()[1][1].with_(
                dtype=torch.float32, kv_cache_dtype=torch.float32)),):
        mod = family_module(cfg)
        params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(
            DIST_SEED), "cuda")
        cache = mod.init_cache(cfg, MAX_BATCH, CACHE_LEN, device="cuda")
        # the fp32 run at full depth decodes the bf16 run's tokens: the
        # bf16 yardstick (``_dist_mesh_rank``)
        follow = (one["tp-bf16"]["greedy"][:, :-1] if tag == "fp32-full"
                  else None)
        one[f"tp-{tag}"] = _mesh_serve(cfg, params, cache, follow)
        cache = one[f"tp-{tag}"].pop("cache")
        one[f"tp-{tag}"].pop("batch")
        if tag == "fp32":               # dist-seq holds its gathered cache
            one["tp-fp32"]["cache"] = tree.tree_map(lambda x: x.cpu(), cache)
        del params, cache
        torch.cuda.empty_cache()
    one["tp-bf16"]["fp32_logits"] = one.pop("tp-fp32-full")["logits"]
    cfg, tcfg = _mesh_train_fp32()
    params = family_module(cfg).init(cfg, torch.Generator(
        device="cuda").manual_seed(DIST_SEED), "cuda")
    _, opt, metrics, _ = make_train_step(cfg, tcfg)(
        params, adamw.init(tcfg.optimizer, params),
        train_batch(cfg, *DIST_TRAIN_FP32_BATCH, "cuda"))
    mu = tree.tree_map(lambda x: x.cpu(), opt["mu"])
    one["train-fp32"] = {"loss": float(metrics["loss"]), "mu_max": [
        float(x.abs().max()) for x in tree.leaves(mu)]}
    torch.save(mu, DIST_DIR / "mesh_train_mu.pt")
    del params, opt, metrics, mu
    torch.cuda.empty_cache()
    args = launch_train.parse_args(DIST_TRAIN_ARGV + ["--device", "cuda"])
    res = launch_train.train(_cut(ARCH, DIST_TRAIN_LAYERS), args)
    one["train"] = {"losses": res.losses, "step_ms": res.step_ms_device}
    del res
    torch.cuda.empty_cache()
    torch.save(one, DIST_DIR / "mesh_one.pt")
    one_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    try:
        run_world(_dist_mesh_rank, DIST_MESH_RANKS, (str(DIST_DIR),),
                  rendezvous=str(DIST_DIR / "rendezvous"),
                  timeout=DIST_MESH_TIMEOUT)
    except Exception as e:                   # a rank failed or hung
        raise PhaseFailed(f"dist-mesh: {type(e).__name__}: {e}") from None
    world_s = time.perf_counter() - t0
    launches = {}
    ranks = [json.loads((DIST_DIR / f"mesh_rank{i}.json").read_text())
             for i in range(DIST_MESH_RANKS)]
    for i, got in enumerate(ranks):
        for path, counts in got["launches"].items():
            launches[f"{path}/rank{i}"] = counts
    emit({"phase": "dist-mesh", "ranks": DIST_MESH_RANKS,
          "backend": ranks[0]["world"]["backend"],
          "backend_reason": ranks[0]["world"]["backend_reason"],
          "devices": [got["world"]["device"] for got in ranks],
          "one_rank_s": one_s, "world_wall_s": world_s,
          "wall_s": time.perf_counter() - t_phase, "launches": launches})
    for f in DIST_DIR.iterdir():            # dist-seq reads mesh_one.pt
        if f.is_dir():
            shutil.rmtree(f)
        elif f.name != "mesh_one.pt":
            f.unlink()
    return launches


# ---------------------------------------------------------------------------
# Serving on a model axis that does not divide the KV heads: the cache
# shared out along its sequence.
# ---------------------------------------------------------------------------

def _seq_serve_launches(cfg, steps: int) -> dict:
    """K1's and K2's launches by tile on one rank of ``dist-seq``: a
    prefill of the serve traffic's first batch and ``steps`` decode
    steps of yi-6b (untied logits, no bias), as on one rank: a layer's
    6 projections (K and V one call each, over every KV head) and the
    logits at M = 4 (K1's decode tile), the prefill's on the tensor-core
    tile in bf16 and the SIMT tile in fp32; one K2 call a layer at
    prefill, decode attention in plain ops."""
    n = cfg.n_layers
    big = "tc" if cfg.dtype == torch.bfloat16 else "simt"
    k1 = {"tc": 0, "decode": 1 + steps * (6 * n + 1), "simt": 0}
    k1[big] += 6 * n
    k2 = {"tc": 0, "simt": 0}
    k2[big] += n
    return {"fused_matmul_by_tile": k1, "flash_attention_by_tile": k2}


def _seq_decode_collectives(cfg, sizes: dict, rows: int) -> dict:
    """Collective bytes by kind of one decode step of a dense model with an
    untied output weight, pre-norms only and no bias (yi-6b) on one rank
    of a mesh of ``sizes`` whose model axis does not divide its KV heads
    (the cache every KV head at the rank's share of the positions), under
    the default rules, ``rows`` rows on the rank.
    ``tests/test_torch_tensor_parallel.py`` holds it to the meta count.

    * all-gather: a layer's weights over data where it is larger than 1,
      whole in d (wq, wk, wv, wo, wi and the MLP's wo, each with its model
      shard); q over model (rows x q_dim: the rank's heads gathered for
      the attention over its positions, or its columns where the q heads
      do not divide the axis); the KV weights over model (d x kv_dim
      each, every KV head computed on every rank) where their columns are
      split; the embedding and the output weight over data, and the
      logits over model (rows x vocab, fp32);
    * all-reduce: a layer's attention row max (rows x heads) and its sum
      of exponentials with P·V (rows x heads x (1 + head_dim)), in fp32,
      and the two region exits (rows x d, fp32); the embedding's sum
      (rows x d, the model's dtype)."""
    d, q, kv, ff, v, n = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff,
                          cfg.padded_vocab, cfg.n_layers)
    e = torch.finfo(cfg.dtype).bits // 8
    m, data = sizes["model"], sizes.get("data", 1)
    fsdp = (d * q + 2 * d * kv + q * d + d * 2 * ff + ff * d) // m * e
    fsdp = fsdp if data > 1 else 0
    kv_gather = 2 * d * kv * e if kv % m == 0 else 0
    vocab = 2 * v // m * d * e if data > 1 else 0
    gather = n * (fsdp + rows * q * e + kv_gather) + vocab + rows * v * 4
    h = cfg.n_heads
    reduce = (n * (rows * h * 4 + rows * h * (1 + cfg.head_dim) * 4
                   + 2 * rows * d * 4) + rows * d * e)
    out = {"all-gather": float(gather), "all-reduce": float(reduce)}
    out["total"] = sum(out.values())
    return out


def _dist_seq_rank(world, out_dir: str) -> None:
    """One rank of phase ``dist-seq``, spawned by ``run_world``: yi-6b
    served on (data 1, model DIST_SEQ_RANKS), whose 4 KV heads the axis
    does not divide, so that the rank's cache holds every KV head at its
    CACHE_LEN / DIST_SEQ_RANKS positions; dist-tp's two runs (fp32 at
    DIST_TP_FP32_LAYERS, bf16 at full depth) held to the same one-rank
    runs.  Each rank builds the whole model on the card in its turn and
    keeps its shards, so that the card holds one whole model at a time.
    Prints a dist-seq-fp32 and a dist-seq-bf16 line, raises on a failed
    check (which fails the world) and writes its launch counts to
    ``out_dir/seq_rank{r}.json``."""
    import torch.distributed as dist
    from repro_torch.core import tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import logical, sharding
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, rank_view
    from repro_torch.models.base import family_module
    from repro_torch.serving.engine import make_decode, make_prefill
    global _EMIT_LOCK
    disable_tf32()
    out_dir, r = Path(out_dir), world.rank
    _EMIT_LOCK = out_dir / "emit.lock"
    one = torch.load(out_dir / "mesh_one.pt")
    head = {"rank": r, "world": world.size, "backend": world.backend,
            "backend_reason": world.reason, "device": str(world.device)}
    dense = {"fused_matmul": fused_matmul, "flash_attention": flash_attention}
    mesh = make_mesh((1, DIST_SEQ_RANKS), ("data", "model"))
    view = rank_view(tuple(mesh.shape.values()), mesh.axis_names,
                     mesh.coordinate)
    s = int(max(prompt_lengths()[0][:MAX_BATCH]))
    launches = {}
    for tag, cfg in _mesh_tp_configs():
        mod = family_module(cfg)
        for turn in range(world.size):
            if turn == r:
                whole = mod.init(cfg, torch.Generator(
                    device="cuda").manual_seed(DIST_SEED), "cuda")
                params = sharding.shard_params(whole, mesh, glu=cfg.mlp_glu)
                del whole
                torch.cuda.empty_cache()
            dist.barrier()
        cache = sharding.shard_cache(mod.init_cache(
            cfg, MAX_BATCH, CACHE_LEN, device="cuda"), mesh, cfg)
        torch.cuda.empty_cache()
        ref = one[f"tp-{tag}"]
        read = _counted(dense)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with logical.use_rules(mesh):
            got = _mesh_serve(cfg, params, cache,
                              follow=ref["greedy"][:, :-1])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = read()
        errs = [rel_err(a, b)[0] for a, b in zip(got["logits"],
                                                 ref["logits"])]
        agree = float((got["greedy"] == ref["greedy"]).float().mean())
        line = {}
        if tag == "bf16":
            fp32 = ref["fp32_logits"]
            line["l2_vs_one_rank_over_one_rank_bf16_vs_fp32"] = [
                l2_dist(a, b) / l2_dist(b, c) for a, b, c in
                zip(got["logits"], ref["logits"], fp32)]
            line["tol_ratio"] = TOL_TP_BF16
        else:
            # the cache gathered from every rank's share against one rank's
            whole = sharding.gather_cache(got["cache"], mesh, cfg)
            pairs = list(zip(tree.leaves(whole), tree.leaves(ref["cache"])))
            line["cache_rel_err"] = max(rel_err(a.cpu(), b)[0]
                                        for a, b in pairs)
            line["cache_bit_equal"] = all(torch.equal(a.cpu(), b)
                                          for a, b in pairs)
            del whole, pairs
        # one more decode step, counted on the card and on meta at this
        # rank's coordinate; the serve steps' peak against the meta trace
        tok = ref["greedy"][:, -1:].to("cuda", torch.int32)
        pos = s + DIST_TP_DECODE
        with logical.use_rules(mesh):
            card, _, _ = dryrun.count_step(make_decode(cfg), (
                params, tok, got["cache"], pos), False)
        with logical.use_rules(view):
            meta_params = sharding.shard_params(mod.init(cfg, None, "meta"),
                                                view, glu=cfg.mlp_glu)
            meta_cache = sharding.shard_cache(mod.init_cache(
                cfg, MAX_BATCH, CACHE_LEN, device="meta"), view, cfg)
            tokens = torch.empty((MAX_BATCH, s), dtype=torch.int32,
                                 device="meta")
            pre, _, _ = dryrun.count_step(make_prefill(cfg), (
                meta_params, {"tokens": tokens}, meta_cache), False)
            meta, _, _ = dryrun.count_step(make_decode(cfg), (
                meta_params, tokens[:, :1], meta_cache, pos), False)
        mem = {"arguments": dryrun.tree_bytes((meta_params, meta_cache,
                                                tokens)),
               "temp_meta": max(pre.temp_bytes, meta.temp_bytes)}
        mem["total"] = mem["arguments"] + mem["temp_meta"]
        counted = {**{k: float(x) for k, x in card.per_collective.items()},
                   "total": card.collective_bytes}
        reckoned = _seq_decode_collectives(cfg, dict(mesh.shape), MAX_BATCH)
        tiles = _seq_serve_launches(cfg, DIST_TP_DECODE)
        phase = f"dist-seq-{tag}"
        emit({"phase": phase, **head, **counts,
              "config": f"{ARCH} full width, {cfg.n_layers} layers, "
                        f"{str(cfg.dtype)[6:]}, (data 1, model "
                        f"{DIST_SEQ_RANKS}): {cfg.n_heads // DIST_SEQ_RANKS}"
                        f" q heads a rank, every KV head at positions "
                        f"[{r * CACHE_LEN // DIST_SEQ_RANKS}, "
                        f"{(r + 1) * CACHE_LEN // DIST_SEQ_RANKS})",
              "cache_held": list(cache[0][0].shape),
              "logits_rel_err": errs, "tol": TOL_PATH if tag == "fp32"
              else None, **line, "greedy_tokens_agree": agree,
              "launches_reckoned": tiles,
              "collective_bytes_decode_step": counted,
              "collective_bytes_meta": meta.per_collective,
              "collective_bytes_reckoned": reckoned,
              "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
              "one_rank_prefill_ms": ref["prefill_ms"],
              "one_rank_decode_ms": ref["decode_ms"],
              "max_memory_allocated": peak, "memory_reckoned": mem,
              "memory_rel": peak / mem["total"] - 1.0,
              "tol_memory": TOL_TRAIN_MEMORY})
        require(all(bool(torch.isfinite(x).all()) for x in got["logits"]),
                f"{phase}: logits not finite")
        if tag == "fp32":
            require(all(e_ <= TOL_PATH for e_ in errs),
                    f"{phase}: logits {errs} against {TOL_PATH}")
            require(agree == 1.0, f"{phase}: greedy tokens differ from one "
                    "rank's")
            require(line["cache_rel_err"] <= TOL_PATH,
                    f"{phase}: gathered cache {line['cache_rel_err']} "
                    "from one rank's")
        else:
            ratio = line["l2_vs_one_rank_over_one_rank_bf16_vs_fp32"]
            require(all(x <= TOL_TP_BF16 for x in ratio),
                    f"{phase}: {ratio} against {TOL_TP_BF16}")
        require({k: counts[k] for k in tiles} == tiles,
                f"{phase}: launches {counts}, reckoned {tiles}")
        require(counted == reckoned and card.per_collective
                == meta.per_collective, f"{phase}: a decode step's "
                f"collective bytes {counted}, meta {meta.per_collective}, "
                f"reckoned {reckoned}")
        require(abs(peak / mem["total"] - 1.0) <= TOL_TRAIN_MEMORY,
                f"{phase}: peak {peak} B against {mem['total']} B reckoned")
        launches[phase] = counts
        del params, cache, got, card, meta, pre
        torch.cuda.empty_cache()
    (out_dir / f"seq_rank{r}.json").write_text(json.dumps(
        {"world": head, "launches": launches}))


def phase_dist_seq():
    """yi-6b served on DIST_SEQ_RANKS ranks of (data 1, model
    DIST_SEQ_RANKS) through ``launch.mesh.run_world`` (gloo: the ranks
    share the card), its cache shared out along the sequence
    (``_dist_seq_rank``), held to ``phase_dist_mesh``'s one-rank runs
    (``mesh_one.pt``).  A rank that fails, or a world that outlives
    DIST_SEQ_TIMEOUT, fails the phase."""
    import shutil

    from repro_torch.launch.mesh import run_world
    t0 = time.perf_counter()
    try:
        run_world(_dist_seq_rank, DIST_SEQ_RANKS, (str(DIST_DIR),),
                  rendezvous=str(DIST_DIR / "rendezvous"),
                  timeout=DIST_SEQ_TIMEOUT)
    except Exception as e:                   # a rank failed or hung
        raise PhaseFailed(f"dist-seq: {type(e).__name__}: {e}") from None
    ranks = [json.loads((DIST_DIR / f"seq_rank{i}.json").read_text())
             for i in range(DIST_SEQ_RANKS)]
    launches = {f"{path}/rank{i}": counts for i, got in enumerate(ranks)
                for path, counts in got["launches"].items()}
    emit({"phase": "dist-seq", "ranks": DIST_SEQ_RANKS,
          "backend": ranks[0]["world"]["backend"],
          "backend_reason": ranks[0]["world"]["backend_reason"],
          "wall_s": time.perf_counter() - t0, "launches": launches})
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# The recurrent families and Whisper on a mesh: Griffin's channels, RWKV-6's
# heads and Whisper's heads on each rank.
# ---------------------------------------------------------------------------

def _rec_serve_configs():
    """(tag, config) of ``dist-rec``'s serving runs: each family at full
    width in fp32 at its DIST_REC_FP32_LAYERS, then Griffin and RWKV-6 at
    full depth in bf16."""
    out = [(f"{arch}-fp32", _cut(arch, n, dtype=torch.float32,
                                 kv_cache_dtype=torch.float32))
           for arch, n in DIST_REC_FP32_LAYERS.items()]
    return out + [(f"{arch}-bf16", _cut(arch, None))
                  for arch in (GRIFFIN_ARCH, RWKV_ARCH)]


def _rec_train_fp32(arch):
    """(config, TrainConfig) of a ``dist-rec`` train step: ``arch`` at full
    width, DIST_REC_TRAIN_LAYERS, fp32, remat "full", the plain torch route
    with K1 for the projections, one AdamW step."""
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainConfig
    cfg = _cut(arch, DIST_REC_TRAIN_LAYERS[arch], dtype=torch.float32,
               backend="torch")
    return cfg, TrainConfig(
        optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        loss_chunk=DIST_TRAIN_FP32_BATCH[1])


def _rec_serve_launches(cfg) -> dict:
    """K5's and K6's launches on one rank of ``dist-rec`` serving the
    first batch and its decode steps, as on one rank: a prefill runs
    Griffin's stack twice (the sequence pass, then the stateful pass over
    the window's tail), one K5 call a recurrent layer each; RWKV-6's
    stateful prefill one K6 call a layer (the tensor-core tile in bf16,
    the SIMT tile in fp32); a decode step runs neither (the one-token
    steps are plain)."""
    if cfg.family == "griffin":
        rec = sum(1 for i in range(cfg.n_layers)
                  if cfg.rnn.block_pattern[i % len(cfg.rnn.block_pattern)]
                  == "rec")
        return {"rglru_scan": 2 * rec}
    if cfg.family == "rwkv6":
        big = "tc" if cfg.dtype == torch.bfloat16 else "simt"
        return {"rwkv6_scan_by_tile": {"tc": 0, "simt": 0,
                                       big: cfg.n_layers}}
    return {}


def _rec_decode_collectives(cfg, sizes: dict, rows: int,
                            cache_len: int) -> dict:
    """Collective bytes by kind of one decode step of Griffin, RWKV-6 or
    Whisper on one rank of a mesh of ``sizes`` (data and model; the
    embedding axis is data's alone), under the default rules, ``rows``
    rows on the rank of a batch of rows x data, a cache of ``cache_len``
    (Whisper's self cache).  ``tests/test_torch_tensor_parallel.py``
    holds it to the meta count.  Everywhere:

    * all-gather: each layer's weights over data where it is larger than
      1, whole in d with their model shards (FSDP); the embedding twice
      (its lookup, and the tied logits; RWKV-6's lm_head) over data; the
      logits over model (rows x vocab, fp32);
    * all-reduce: each row-parallel exit (rows x d, fp32) and the
      embedding's sum (rows x d, the model's dtype).

    Griffin: a recurrent layer gathers its conv output over model (rows
    x d_rnn); an attention layer its q columns (every head a rank where
    the q heads do not divide model, or for the ring split over model)
    and its KV weights (every KV head computed a rank), and with its ring
    split along the window all-reduces the row max and the sum of
    exponentials with P·V; the state is written back gathered over model
    (conv tail and carry, every stacked layer at once) and, for the
    unstacked tail, over data along the rows, after its carry's channels
    (split over data) were gathered on reading.  RWKV-6: the channel
    mix's receptance gathered over model (rows x d).  Whisper: q of the
    self- and cross-attention gathered where the heads do not divide
    model, the self-attention's KV weights too (every head computed),
    and each cache split along its positions all-reduces its row max and
    sums."""
    d, n, e = cfg.d_model, cfg.n_layers, torch.finfo(cfg.dtype).bits // 8
    m, data = sizes.get("model", 1), sizes.get("data", 1)
    if "pod" in sizes:
        raise ValueError("reckoned for (data, model) meshes")
    v, ff, q, kv = cfg.padded_vocab, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    h, hd = cfg.n_heads, cfg.head_dim
    big = m > 1

    def split(x):                   # a dim over model, where it divides
        return x // m if x % m == 0 else x

    def fsdp(*sizes_):              # (rows, cols) of weights over data
        return sum(r_ * split(c_) for r_, c_ in sizes_) * e if data > 1 \
            else 0
    gather = (2 * split(v) * d * e if data > 1 else 0) + (
        rows * v * 4 if big else 0)
    reduce = rows * d * e if big else 0
    exits = 0
    attend = rows * h * 4 + rows * h * (1 + hd) * 4     # max, then sums
    if cfg.family == "rwkv6":
        gather += n * (fsdp((d, d), (d, d), (d, d), (d, d), (d, d),
                            (d, d), (d, ff), (ff, d))
                       + (rows * d * e if big else 0))
        exits = 2 * n
    elif cfg.family == "griffin":
        c, w = cfg.rnn.d_rnn, cfg.rnn.conv_width - 1
        pat = cfg.rnn.block_pattern
        triples = n // len(pat)
        tail = n - triples * len(pat)
        n_rec = triples * pat.count("rec") + tail
        n_attn = n - n_rec
        mlp = ((d, 2 * ff), (ff, d))
        gather += n_rec * (fsdp((d, c), (d, c), (c, d), *mlp)
                           + (rows * c * e if big else 0))
        ring_split = big and cfg.window % m == 0
        gather_q = big and (h % m != 0 or ring_split)
        gather += n_attn * (fsdp((d, q), (d, kv), (d, kv), (q, d), *mlp)
                            + (rows * q * e if gather_q else 0)
                            + (2 * d * kv * e if big and kv % m == 0
                               else 0))
        reduce += n_attn * attend if ring_split else 0
        exits = 2 * n
        if big:                     # the state gathered over model
            gather += (triples * pat.count("rec") + tail) * rows * c * (
                w * e + 4)
        if data > 1 and tail:
            b = rows * data
            gather += tail * b * c * (w * e + 4)          # over the rows
            gather += tail * b * c * 4 if c % data == 0 else 0   # read
            gather += tail * b * w * c * e if w % data == 0 else 0
    elif cfg.family == "encdec":
        every = big and h % m != 0
        mlp = ((d, ff), (ff, d))
        gather += n * (fsdp((d, q), (d, kv), (d, kv), (q, d), (d, q),
                            (q, d), *mlp)
                       + (2 * rows * q * e if every else 0)
                       + (2 * d * kv * e if every and kv % m == 0 else 0))
        for length in (cache_len, cfg.encdec.n_audio_ctx):
            reduce += n * attend if every and length % m == 0 else 0
        exits = 3 * n
    else:
        raise ValueError(f"no reckoning for the {cfg.family} family")
    reduce += exits * rows * d * 4 if big else 0
    out = {"all-gather": float(gather), "all-reduce": float(reduce)}
    out = {k: x for k, x in out.items() if x}
    out["total"] = sum(out.values())
    return out


def _rec_kernel_checks(gen, model: int, s=None) -> list:
    """K5 and K6 against their plain versions at a rank's shapes on
    (data 1, model ``model``), over ``s`` tokens (the first batch's where
    None): K5 on Griffin's d_rnn / model channels of
    the first batch, fp32 with a carried state, bit for bit; K6's
    tensor-core tile on RWKV-6's heads / model, bf16 with a carried state
    (the output within TOL_BF16 over the tensor and row by row, the
    state within TOL_WKV_FP32)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    g, r_ = get_config(GRIFFIN_ARCH), get_config(RWKV_ARCH)
    s = s or int(max(prompt_lengths()[0][:MAX_BATCH]))
    out = []
    args = lru_case(gen, MAX_BATCH, s, g.rnn.d_rnn // model, h0=True)
    h, last = run_lru(*args)
    ref, ref_last = plain_lru(*args)
    out.append({"kernel": "rglru_scan", "shape": list(args[1].shape),
                "bit_equal": bool(torch.equal(h, ref)
                                  and torch.equal(last, ref_last)),
                "ok": bool(torch.equal(h, ref)
                           and torch.equal(last, ref_last))})
    shape = (MAX_BATCH, r_.n_heads // model, s, r_.rwkv.head_size)
    args = wkv_case(gen, *shape, torch.bfloat16, s0=True)
    before = dict(rwkv6_scan.launches_by_tile)
    o, st = run_wkv(*args, chunk=64)
    tile = [t for t, n in rwkv6_scan.launches_by_tile.items()
            if n != before[t]]
    ref, ref_st = plain_wkv(*args, chunk=64)
    errs = {"out": rel_err(o, ref)[0], "out_rows": row_rel_err(o, ref)[0],
            "state": rel_err(st, ref_st)[0]}
    out.append({"kernel": "rwkv6_wkv", "shape": list(shape), "tile": tile,
                **errs, "ok": tile == ["tc"] and errs["out"] <= TOL_BF16
                and errs["out_rows"] <= TOL_BF16
                and errs["state"] <= TOL_WKV_FP32})
    return out


def _gspmd_serve_launches(cfg, steps: int) -> dict:
    """K1's, K2's and K4's launches by tile on one rank of ``dist-gspmd``
    (OLMoE): a prefill of the serve traffic's first batch (2 of its 4
    rows a data rank) and ``steps`` decode steps.  A layer's 4 attention
    projections and the logits at M = 4 on K1's decode tile, the
    prefill's on the tensor-core tile in bf16 and the SIMT tile in fp32;
    one K2 call a layer at prefill (decode attention in plain ops); both
    expert GEMMs of a layer on K4 at the whole batch's capacity: 144 at
    prefill (tc in bf16, simt in fp32), 8 at decode (the decode tile)."""
    n = cfg.n_layers
    big = "tc" if cfg.dtype == torch.bfloat16 else "simt"
    k1 = {"tc": 0, "decode": 1 + steps * (4 * n + 1), "simt": 0}
    k1[big] += 4 * n
    k4 = {"tc": 0, "decode": steps * 2 * n, "simt": 0}
    k4[big] += 2 * n
    k2 = {"tc": 0, "simt": 0}
    k2[big] += n
    return {"fused_matmul_by_tile": k1, "flash_attention_by_tile": k2,
            "grouped_matmul_by_tile": k4}


def _gspmd_decode_collectives(cfg, sizes: dict, rows: int,
                              tp: bool, every: bool = False) -> dict:
    """Collective bytes by kind of one decode step of OLMoE on one rank of
    a (data, model) mesh of ``sizes``, ``rows`` rows on the rank, under
    GSPMD_RULES (``tp``: the attention's heads and the vocabulary split
    over model as well) or GSPMD_WHOLE_RULES (the dense leaves whole), or
    with ``every`` under GSPMD_EVERY_RULES (the experts over data and
    model, the dense leaves under the default rules: ``tp``, and FSDP
    over data, which gathers each layer's attention weights, whole in d
    with their model shards, and its router, and the embedding and
    output weights).  ``tests/test_torch_gspmd_ep.py`` and
    ``tests/test_torch_gspmd_train.py`` hold it to the meta count.

    * all-gather: each MoE layer's input over data (rows x data x d, the
      model's dtype); with ``tp``, the logits over model (rows x padded
      vocab, fp32);
    * reduce-scatter: each MoE layer's fp32 partial over data, the
      rank's rows (rows x d x 4);
    * all-reduce: each MoE layer's partial over model (rows x d x 4);
      with ``tp``, each attention exit (rows x d x 4) and the embedding's
      sum (rows x d, the model's dtype).
    No expert weight moves."""
    d, n = cfg.d_model, cfg.n_layers
    e = torch.finfo(cfg.dtype).bits // 8
    data, model = sizes.get("data", 1), sizes.get("model", 1)
    gather = n * rows * data * d * e if data > 1 else 0
    scatter = n * rows * d * 4 if data > 1 else 0
    reduce = n * rows * d * 4 if model > 1 else 0
    if tp and model > 1:
        gather += rows * cfg.padded_vocab * 4
        reduce += n * rows * d * 4 + rows * d * e
    if every and data > 1:
        q, kv = cfg.q_dim // model, cfg.kv_dim // model
        gather += n * ((2 * d * q + 2 * d * kv) * e + d * cfg.moe.n_experts
                       * 4) + 2 * cfg.padded_vocab // model * d * e
    out = {k: float(v) for k, v in (("all-gather", gather),
                                    ("reduce-scatter", scatter),
                                    ("all-reduce", reduce)) if v}
    out["total"] = sum(out.values())
    return out


def _gspmd_train_collectives(cfg, sizes: dict, rows: int, seq: int) -> dict:
    """Collective bytes by kind of one train step of OLMoE (one
    microbatch, remat "full", one loss chunk of ``seq``, fp32 gradients
    of the model's dtype) on one rank of a (data, model) mesh of
    ``sizes`` under GSPMD_RULES, ``rows`` rows of ``seq`` tokens on the
    rank.  ``tests/test_torch_gspmd_train.py`` holds it to the meta count.
    With a the rows' activations (rows x seq x d) in the model's dtype
    and a4 in fp32, a layer:

    * all-gather: x over data in the forward and in remat's recompute
      (data x a each), and in the backward the fp32 partial's gradient
      over data (data x a4, the reduce-scatter's adjoint);
    * reduce-scatter: the fp32 partial over data in the forward (a4; the
      recompute stops at the last tensor the backward needs, before it),
      and in the backward x's gradient over data (a, the gather's
      adjoint);
    * all-reduce: the partial over model (a4) and the attention's exit
      (a4, and again in the recompute) in the forward; in the backward
      the attention's entry and the MoE's x entry (a each), the router's
      gradient (d x experts, fp32) and the QK-norm scales' (2 x
      head_dim).

    A step: the embedding's sum (a) and the loss's entry (a) once; the
    loss chunk's row max, sum of exponentials and label logit (rows x
    seq, fp32) in the forward and its recompute; the token count, the
    loss, its nll and z over data; every leaf but the experts' gradient
    over data (the data-parallel sum: the rules replicate them there);
    the clipping norm over every axis."""
    from repro_torch.core import tree
    from repro_torch.distributed import logical, sharding
    from repro_torch.launch.mesh import rank_view
    from repro_torch.models.base import family_module
    d, n = cfg.d_model, cfg.n_layers
    e = torch.finfo(cfg.dtype).bits // 8
    data, model = sizes.get("data", 1), sizes.get("model", 1)
    a, a4 = rows * seq * d * e, rows * seq * d * 4
    gather = scatter = reduce = 0
    if data > 1:
        gather += n * (2 * data * a + data * a4)
        scatter += n * (a4 + a)
        view = rank_view(tuple(sizes.values()), tuple(sizes))
        with logical.use_rules(view, GSPMD_RULES):
            local = sharding.shard_params(family_module(cfg).init(
                cfg, None, "meta"), view, GSPMD_RULES, glu=cfg.mlp_glu)
        reduce += e * sum(x.numel() for p_, x in tree.flatten_with_path(
            local) if tree.path_str(p_).split("/")[-1] not in (
                "experts_wi", "experts_wo"))
        reduce += 4 * 4
    if model > 1:
        reduce += n * (3 * a4 + 2 * a + d * cfg.moe.n_experts * 4
                       + 2 * cfg.head_dim * e) + 2 * a
        reduce += 2 * 3 * rows * seq * 4
    reduce += 4 * sum(1 for x in sizes.values() if x > 1)
    out = {k: float(v) for k, v in (("all-gather", gather),
                                    ("reduce-scatter", scatter),
                                    ("all-reduce", reduce)) if v}
    out["total"] = sum(out.values())
    return out


def _dist_rec_rank(world, out_dir: str) -> None:
    """One rank of phase ``dist-rec``, spawned by ``run_world``: serves
    each of ``_rec_serve_configs`` on (data 1, model DIST_REC_RANKS) and
    takes each family's train step on (data 2, model 2), held to the
    parent's one-rank runs (``rec_one.pt``); checks K5 and K6 at its
    shapes.  Each rank builds a whole model on the card in its turn and
    keeps its shards; a run's peak is the process's over the serve steps
    less cuBLAS's workspace (taken first, and measured), so that whatever
    one run leaves behind counts in the next one's peak.
    Prints a dist-rec-serve line a run, a
    dist-rec-train line a family and a dist-rec-kernels line, raises on
    a failed check (which fails the world) and writes its launch counts
    to ``out_dir/rec_rank{r}.json``."""
    import torch.distributed as dist
    from repro_torch.core import tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import collectives, logical, sharding
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, rank_view
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import make_decode, make_prefill
    from repro_torch.training.train_step import make_train_step
    global _EMIT_LOCK
    disable_tf32()
    out_dir, r = Path(out_dir), world.rank
    _EMIT_LOCK = out_dir / "emit.lock"
    one = torch.load(out_dir / "rec_one.pt")
    head = {"rank": r, "world": world.size, "backend": world.backend,
            "backend_reason": world.reason, "device": str(world.device)}
    wrappers = {"fused_matmul": fused_matmul,
                "flash_attention": flash_attention,
                "rglru_scan": rglru_scan, "rwkv6_scan": rwkv6_scan}
    mesh = make_mesh((1, DIST_REC_RANKS), ("data", "model"))
    view = rank_view(tuple(mesh.shape.values()), mesh.axis_names,
                     mesh.coordinate)
    s = int(max(prompt_lengths()[0][:MAX_BATCH]))
    launches = {}
    # cuBLAS's workspace (32 MiB on Hopper) is allocated at the first
    # product through it and held by the process, which the reckoning
    # does not count: take it before any run and measure it
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.ones((8, 8), device="cuda") @ torch.ones((8, 8), device="cuda")
    torch.cuda.synchronize()
    workspace = torch.cuda.memory_allocated() - base

    def built(cfg, mesh_):
        """The rank's shards of the seeded model, each rank in its turn."""
        mod = family_module(cfg)
        for turn in range(world.size):
            if turn == r:
                whole = mod.init(cfg, torch.Generator(
                    device="cuda").manual_seed(DIST_SEED), "cuda")
                params = sharding.shard_params(whole, mesh_,
                                               glu=cfg.mlp_glu)
                del whole
                torch.cuda.empty_cache()
            dist.barrier()
        return params

    for tag, cfg in _rec_serve_configs():
        mod = family_module(cfg)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()        # before the run
        params = built(cfg, mesh)
        cache = sharding.shard_cache(mod.init_cache(
            cfg, MAX_BATCH, CACHE_LEN, device="cuda"), mesh, cfg)
        ref = one[f"serve-{tag}"]
        read = _counted(wrappers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with logical.use_rules(mesh):
            got = _mesh_serve(cfg, params, cache,
                              follow=ref["greedy"][:, :-1])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - workspace
        counts = read()
        errs = [rel_err(a, b)[0] for a, b in zip(got["logits"],
                                                 ref["logits"])]
        agree = float((got["greedy"] == ref["greedy"]).float().mean())
        line = {}
        fp32 = cfg.dtype == torch.float32
        if fp32:
            whole = sharding.gather_cache(got["cache"], mesh, cfg)
            pairs = list(zip(tree.leaves(whole), tree.leaves(ref["cache"])))
            line["cache_rel_err"] = max(rel_err(a.cpu(), b)[0]
                                        for a, b in pairs)
            del whole, pairs
        else:
            line["l2_vs_one_rank_over_one_rank_bf16_vs_fp32"] = [
                l2_dist(a, b) / l2_dist(b, c) for a, b, c in
                zip(got["logits"], ref["logits"], ref["fp32_logits"])]
            line["tol_ratio"] = TOL_TP_BF16_REC[cfg.name]
        # one more decode step, counted on the card and on meta at this
        # rank's coordinate; the serve steps' peak against the meta trace
        tok = ref["greedy"][:, -1:].to("cuda", torch.int32)
        pos = s + DIST_TP_DECODE
        with logical.use_rules(mesh):
            card, _, _ = dryrun.count_step(make_decode(cfg), (
                params, tok, got["cache"], pos), False)
        with logical.use_rules(view):
            meta_params = sharding.shard_params(
                mod.init(cfg, None, "meta"), view, glu=cfg.mlp_glu)
            meta_cache = sharding.shard_cache(mod.init_cache(
                cfg, MAX_BATCH, CACHE_LEN, device="meta"), view, cfg)
            batch = {k: torch.empty(x.shape, dtype=x.dtype, device="meta")
                     for k, x in got["batch"].items()}
            pre, _, _ = dryrun.count_step(make_prefill(cfg), (
                meta_params, batch, meta_cache), False)
            meta, _, _ = dryrun.count_step(make_decode(cfg), (
                meta_params, batch["tokens"][:, :1], meta_cache, pos), False)
        mem = {"arguments": dryrun.tree_bytes((meta_params, meta_cache,
                                                batch)),
               "temp_meta": max(pre.temp_bytes, meta.temp_bytes)}
        mem["total"] = mem["arguments"] + mem["temp_meta"]
        counted = {**{k: float(x) for k, x in card.per_collective.items()},
                   "total": card.collective_bytes}
        reckoned = _rec_decode_collectives(cfg, dict(mesh.shape), MAX_BATCH,
                                           CACHE_LEN)
        kernels = _rec_serve_launches(cfg)
        phase = "dist-rec-serve"
        emit({"phase": phase, **head, "run": tag, **counts,
              "config": f"{cfg.name} full width, {cfg.n_layers} layers, "
                        f"{str(cfg.dtype)[6:]}, (data 1, model "
                        f"{DIST_REC_RANKS})",
              "cache_held": {tree.path_str(p_): list(x.shape)
                             for p_, x in tree.flatten_with_path(
                                 got["cache"])},
              "logits_rel_err": errs, "tol": TOL_FP32 if fp32 else None,
              **line, "greedy_tokens_agree": agree,
              "launches_reckoned": kernels,
              "collective_bytes_decode_step": counted,
              "collective_bytes_meta": meta.per_collective,
              "collective_bytes_reckoned": reckoned,
              "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
              "one_rank_prefill_ms": ref["prefill_ms"],
              "one_rank_decode_ms": ref["decode_ms"],
              "max_memory_allocated": peak, "held_before_run": held,
              "cublas_workspace": workspace,
              "memory_reckoned": mem,
              "memory_rel": peak / mem["total"] - 1.0,
              "tol_memory": TOL_DIST_MEMORY})
        require(all(bool(torch.isfinite(x).all()) for x in got["logits"]),
                f"{phase} {tag}: logits not finite")
        if fp32:
            require(all(e_ <= TOL_FP32 for e_ in errs),
                    f"{phase} {tag}: logits {errs} against {TOL_FP32}")
            require(agree == 1.0, f"{phase} {tag}: greedy tokens differ "
                    "from one rank's")
            require(line["cache_rel_err"] <= TOL_FP32,
                    f"{phase} {tag}: gathered cache {line['cache_rel_err']} "
                    "from one rank's")
        else:
            ratio = line["l2_vs_one_rank_over_one_rank_bf16_vs_fp32"]
            require(all(x <= line["tol_ratio"] for x in ratio),
                    f"{phase} {tag}: {ratio} against {line['tol_ratio']}")
        require({k: counts[k] for k in kernels} == kernels,
                f"{phase} {tag}: launches {counts}, reckoned {kernels}")
        require(counts["fused_matmul"] > 0 and (
            counts["flash_attention"] > 0 or cfg.family == "rwkv6"),
                f"{phase} {tag}: launches {counts}")
        require(counted == reckoned and card.per_collective
                == meta.per_collective, f"{phase} {tag}: a decode step's "
                f"collective bytes {counted}, meta {meta.per_collective}, "
                f"reckoned {reckoned}")
        require(abs(peak / mem["total"] - 1.0) <= TOL_DIST_MEMORY,
                f"{phase} {tag}: peak {peak} B against {mem['total']} B "
                "reckoned")
        launches[f"dist-rec-{tag}"] = counts
        del params, cache, got, card, meta, pre, meta_params, meta_cache
        torch.cuda.empty_cache()

    # one fp32 AdamW step of each family on (data 2, model 2)
    train_mesh = make_mesh((2, 2), ("data", "model"))
    for arch in DIST_REC_TRAIN_LAYERS:
        cfg, tcfg = _rec_train_fp32(arch)
        params = built(cfg, train_mesh)
        opt = adamw.init(tcfg.optimizer, params)
        batch = train_batch(cfg, *DIST_TRAIN_FP32_BATCH, "cuda")
        read = _counted(wrappers)
        with logical.use_rules(train_mesh):
            _, opt, metrics, _ = make_train_step(cfg, tcfg)(
                params, opt, sharding.local_batch(batch, train_mesh))
        counts = read()
        ref = one[f"train-{arch}"]
        ref_mu = sharding.shard_params(
            torch.load(out_dir / f"rec_train_mu_{arch}.pt", mmap=True),
            train_mesh, glu=cfg.mlp_glu)
        worst = torch.stack([(a - b.cuda()).abs().max().float() for a, b in
                             zip(tree.leaves(opt["mu"]),
                                 tree.leaves(ref_mu))])
        collectives.all_reduce(worst, op="max")
        grad_rel = (worst.cpu() / torch.tensor(ref["mu_max"])).tolist()
        loss = float(metrics["loss"])
        loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        emit({"phase": "dist-rec-train", **head, **counts,
              "config": f"{arch} full width, {cfg.n_layers} layers, fp32, "
                        f"(data 2, model 2), batch {DIST_TRAIN_FP32_BATCH}",
              "loss": loss, "one_rank_loss": ref["loss"],
              "loss_rel": loss_rel, "tol_loss": TOL_TRAIN_LOSS,
              "mu_rel_max": max(grad_rel), "tol_grad": TOL_TRAIN_GRAD})
        require(loss_rel <= TOL_TRAIN_LOSS, f"dist-rec-train {arch}: loss "
                f"{loss} against one rank's {ref['loss']}")
        require(max(grad_rel) <= TOL_TRAIN_GRAD, f"dist-rec-train {arch}: "
                f"first moment {max(grad_rel)} of a leaf's max")
        require(counts["fused_matmul"] > 0 and counts["rglru_scan"] == 0
                and counts["rwkv6_scan"] == 0,
                f"dist-rec-train {arch}: launches {counts}")
        launches[f"dist-rec-train-{arch}"] = counts
        del params, opt, ref_mu, metrics
        torch.cuda.empty_cache()

    checks = _rec_kernel_checks(torch.Generator(device="cuda").manual_seed(
        DIST_SEED + r), DIST_REC_RANKS)
    emit({"phase": "dist-rec-kernels", **head, "checks": checks})
    require(all(c["ok"] for c in checks), f"dist-rec-kernels: {checks}")
    (out_dir / f"rec_rank{r}.json").write_text(json.dumps(
        {"world": head, "launches": launches}))


def _rec_split_config():
    """Reduced RWKV-6 in fp32 (d 128, 4 heads of 32), DIST_REC_SPLIT's."""
    from repro_torch.configs.registry import get_config
    return get_config(RWKV_ARCH, reduced=True).with_(
        dtype=torch.float32, kv_cache_dtype=torch.float32)


def _rec_split_batch(cfg):
    """4 prompts of DIST_REC_SPLIT_PROMPT tokens, numpy seed DIST_SEED."""
    rng = np.random.default_rng(DIST_SEED)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MAX_BATCH, DIST_REC_SPLIT_PROMPT))).to(
            device="cuda", dtype=torch.int32)}


def _dist_rec_split_rank(world, out_dir: str) -> None:
    """One rank of dist-rec's last part, spawned by ``run_world``: reduced
    RWKV-6 served on (data 1, model DIST_REC_SPLIT_RANKS), a model axis
    that splits its heads, without and with SP_RULES, held to the
    parent's one process (``rec_split_one.pt``); K6 checked at the shape
    each rank runs it.  Prints a dist-rec-split line a run and a
    dist-rec-split-kernel line, raises on a failed check and writes its
    launch counts to ``out_dir/rec_split_rank{r}.json``."""
    from repro_torch.core import tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import logical, sharding
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.base import family_module
    global _EMIT_LOCK
    disable_tf32()
    out_dir, r = Path(out_dir), world.rank
    _EMIT_LOCK = out_dir / "emit.lock"
    one = torch.load(out_dir / "rec_split_one.pt")
    head = {"rank": r, "world": world.size, "backend": world.backend,
            "backend_reason": world.reason, "device": str(world.device)}
    cfg = _rec_split_config()
    mod = family_module(cfg)
    mesh = make_mesh((1, DIST_REC_SPLIT_RANKS), ("data", "model"))
    cache_len = DIST_REC_SPLIT_PROMPT + DIST_REC_SPLIT_DECODE
    kernels = {"rwkv6_scan_by_tile": {"tc": 0, "simt": cfg.n_layers}}
    launches = {}
    for tag, rules in (("heads", None), ("seq", SP_RULES)):
        params = sharding.shard_params(mod.init(cfg, torch.Generator(
            device="cuda").manual_seed(DIST_SEED), "cuda"), mesh, rules,
            glu=cfg.mlp_glu)
        cache = sharding.shard_cache(mod.init_cache(
            cfg, MAX_BATCH, cache_len, device="cuda"), mesh, cfg, rules)
        held = list(cache["wkv"].shape)
        read = _counted({"fused_matmul": fused_matmul,
                         "rwkv6_scan": rwkv6_scan})
        with logical.use_rules(mesh, rules):
            got = _mesh_serve(cfg, params, cache,
                              follow=one["greedy"][:, :-1],
                              batch=_rec_split_batch(cfg),
                              steps=DIST_REC_SPLIT_DECODE)
        counts = read()
        errs = [rel_err(a, b)[0] for a, b in zip(got["logits"],
                                                 one["logits"])]
        agree = float((got["greedy"] == one["greedy"]).float().mean())
        whole = sharding.gather_cache(got["cache"], mesh, cfg, rules)
        cache_errs = {tree.path_str(p_): rel_err(a.cpu(), b)[0]
                      for (p_, a), b in zip(tree.flatten_with_path(whole),
                                            tree.leaves(one["cache"]))}
        phase = "dist-rec-split"
        emit({"phase": phase, **head, "run": tag, **counts,
              "config": f"{cfg.name} reduced (d {cfg.d_model}, "
                        f"{cfg.n_heads} heads of {cfg.rwkv.head_size}, "
                        f"{cfg.n_layers} layers), fp32, (data 1, model "
                        f"{DIST_REC_SPLIT_RANKS}), rules {rules}; reduced "
                        "because the form needs a model axis of 128 at "
                        "full width (64 heads), which no mesh one card "
                        "can spawn reaches",
              "wkv_state_held": held, "logits_rel_err": errs,
              "tol": TOL_FP32, "greedy_tokens_agree": agree,
              "cache_rel_err": cache_errs, "launches_reckoned": kernels,
              "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
              "one_process_prefill_ms": one["prefill_ms"],
              "one_process_decode_ms": one["decode_ms"]})
        require(held == [cfg.n_layers, MAX_BATCH, cfg.n_heads,
                         cfg.rwkv.head_size // DIST_REC_SPLIT_RANKS,
                         cfg.rwkv.head_size],
                f"{phase} {tag}: the rank's WKV state {held}")
        require(all(bool(torch.isfinite(x).all()) for x in got["logits"]),
                f"{phase} {tag}: logits not finite")
        require(all(e_ <= TOL_FP32 for e_ in errs),
                f"{phase} {tag}: logits {errs} against {TOL_FP32}")
        require(agree == 1.0, f"{phase} {tag}: greedy tokens differ from "
                "one process's")
        require(max(cache_errs.values()) <= TOL_FP32,
                f"{phase} {tag}: gathered cache {cache_errs}")
        require({k: counts[k] for k in kernels} == kernels
                and counts["fused_matmul"] > 0,
                f"{phase} {tag}: launches {counts}, reckoned {kernels}")
        launches[f"{phase}-{tag}"] = counts
        del params, cache, got, whole
    gen = torch.Generator(device="cuda").manual_seed(DIST_SEED + r)
    shape = (MAX_BATCH, cfg.n_heads, DIST_REC_SPLIT_PROMPT,
             cfg.rwkv.head_size)
    args = wkv_case(gen, *shape, torch.float32, s0=True)
    before = dict(rwkv6_scan.launches_by_tile)
    o, st = run_wkv(*args, chunk=64)
    tile = [t for t, k in rwkv6_scan.launches_by_tile.items()
            if k != before[t]]
    ref, ref_st = plain_wkv(*args, chunk=64)
    check = {"kernel": "rwkv6_wkv", "shape": list(shape), "tile": tile,
             "out": rel_err(o, ref)[0], "state": rel_err(st, ref_st)[0]}
    check["ok"] = (tile == ["simt"] and check["out"] <= TOL_WKV_FP32
                   and check["state"] <= TOL_WKV_FP32)
    emit({"phase": "dist-rec-split-kernel", **head, "check": check})
    require(check["ok"], f"dist-rec-split-kernel: {check}")
    (out_dir / f"rec_split_rank{r}.json").write_text(json.dumps(
        {"world": head, "launches": launches}))


def phase_dist_rec():
    """RecurrentGemma-2B, RWKV-6-7B and whisper-tiny served and trained on
    DIST_REC_RANKS ranks through ``launch.mesh.run_world`` (gloo: the
    ranks share the card; ``_dist_rec_rank``).  First, in this process,
    what the ranks are held to, on one rank: each serving run of
    ``_rec_serve_configs`` (``_mesh_serve``; the fp32 runs keep their
    cache, the bf16 runs beside an fp32 run at full depth on their
    tokens, the yardstick) and each family's fp32 train step (its first
    moment saved for the ranks to read).  Then reduced RWKV-6 on a model
    axis that splits its heads: one process's serving run, then
    DIST_REC_SPLIT_RANKS ranks (``_dist_rec_split_rank``).  A rank that
    fails, or a world that outlives its timeout, fails the phase."""
    import shutil

    from repro_torch.core import tree
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import make_train_step
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    one = {}
    for tag, cfg in _rec_serve_configs():
        runs = [(tag, cfg)]
        if cfg.dtype == torch.bfloat16:
            runs.append((tag + "-fp32", cfg.with_(
                dtype=torch.float32, kv_cache_dtype=torch.float32)))
        for run, c in runs:
            mod = family_module(c)
            params = mod.init(c, torch.Generator(device="cuda").manual_seed(
                DIST_SEED), "cuda")
            cache = mod.init_cache(c, MAX_BATCH, CACHE_LEN, device="cuda")
            follow = one[f"serve-{tag}"]["greedy"][:, :-1] if run != tag \
                else None
            got = _mesh_serve(c, params, cache, follow)
            cache = got.pop("cache")
            got.pop("batch")
            if c.dtype == torch.float32 and run == tag:
                got["cache"] = tree.tree_map(lambda x: x.cpu(), cache)
            if run == tag:
                one[f"serve-{tag}"] = got
            else:
                one[f"serve-{tag}"]["fp32_logits"] = got["logits"]
            del params, cache, got
            torch.cuda.empty_cache()
    for arch in DIST_REC_TRAIN_LAYERS:
        cfg, tcfg = _rec_train_fp32(arch)
        params = family_module(cfg).init(cfg, torch.Generator(
            device="cuda").manual_seed(DIST_SEED), "cuda")
        _, opt, metrics, _ = make_train_step(cfg, tcfg)(
            params, adamw.init(tcfg.optimizer, params),
            train_batch(cfg, *DIST_TRAIN_FP32_BATCH, "cuda"))
        mu = tree.tree_map(lambda x: x.cpu(), opt["mu"])
        one[f"train-{arch}"] = {"loss": float(metrics["loss"]), "mu_max": [
            float(x.abs().max()) for x in tree.leaves(mu)]}
        torch.save(mu, DIST_DIR / f"rec_train_mu_{arch}.pt")
        del params, opt, metrics, mu
        torch.cuda.empty_cache()
    torch.save(one, DIST_DIR / "rec_one.pt")
    one_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    try:
        run_world(_dist_rec_rank, DIST_REC_RANKS, (str(DIST_DIR),),
                  rendezvous=str(DIST_DIR / "rendezvous"),
                  timeout=DIST_REC_TIMEOUT)
    except Exception as e:                   # a rank failed or hung
        raise PhaseFailed(f"dist-rec: {type(e).__name__}: {e}") from None
    world_s = time.perf_counter() - t0
    ranks = [json.loads((DIST_DIR / f"rec_rank{i}.json").read_text())
             for i in range(DIST_REC_RANKS)]
    launches = {f"{path}/rank{i}": counts for i, got in enumerate(ranks)
                for path, counts in got["launches"].items()}

    # RWKV-6 on a model axis that splits its heads: one process first
    t0 = time.perf_counter()
    cfg = _rec_split_config()
    mod = family_module(cfg)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(
        DIST_SEED), "cuda")
    got = _mesh_serve(cfg, params, mod.init_cache(
        cfg, MAX_BATCH, DIST_REC_SPLIT_PROMPT + DIST_REC_SPLIT_DECODE,
        device="cuda"), batch=_rec_split_batch(cfg),
        steps=DIST_REC_SPLIT_DECODE)
    got["cache"] = tree.tree_map(lambda x: x.cpu(), got["cache"])
    got.pop("batch")
    torch.save(got, DIST_DIR / "rec_split_one.pt")
    del params, got
    try:
        run_world(_dist_rec_split_rank, DIST_REC_SPLIT_RANKS,
                  (str(DIST_DIR),), rendezvous=str(DIST_DIR / "rendezvous"),
                  timeout=DIST_REC_SPLIT_TIMEOUT)
    except Exception as e:                   # a rank failed or hung
        raise PhaseFailed(f"dist-rec split: {type(e).__name__}: {e}") \
            from None
    split_s = time.perf_counter() - t0
    for i in range(DIST_REC_SPLIT_RANKS):
        got = json.loads((DIST_DIR / f"rec_split_rank{i}.json").read_text())
        launches.update({f"{path}/rank{i}": counts
                         for path, counts in got["launches"].items()})
    emit({"phase": "dist-rec", "ranks": DIST_REC_RANKS,
          "backend": ranks[0]["world"]["backend"],
          "backend_reason": ranks[0]["world"]["backend_reason"],
          "one_rank_s": one_s, "world_wall_s": world_s,
          "split_heads_ranks": DIST_REC_SPLIT_RANKS,
          "split_heads_wall_s": split_s,
          "wall_s": time.perf_counter() - t_phase, "launches": launches})
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# GSPMD expert parallelism: OLMoE's experts over data, each expert's d_ff
# over model, the tokens gathered and the partials summed.
# ---------------------------------------------------------------------------

def _gspmd_configs():
    """(tag, config, rules) of ``dist-gspmd``'s serving runs: OLMoE-1B-7B
    at full width with ``moe_shard_map=False``, DIST_GSPMD_FP32_LAYERS in
    fp32 under GSPMD_RULES, then DIST_GSPMD_BF16_LAYERS in bf16 under
    GSPMD_WHOLE_RULES, then the fp32 configuration under
    GSPMD_EVERY_RULES ("every-fp32", held to the fp32 run's one
    process)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(MOE_ARCH).with_(moe_shard_map=False)
    fp32 = cfg.with_(n_layers=DIST_GSPMD_FP32_LAYERS, dtype=torch.float32,
                     kv_cache_dtype=torch.float32)
    return (("fp32", fp32, GSPMD_RULES),
            ("bf16", cfg.with_(n_layers=DIST_GSPMD_BF16_LAYERS),
             GSPMD_WHOLE_RULES),
            ("every-fp32", fp32, GSPMD_EVERY_RULES))


def _gspmd_train_config():
    """(config, TrainConfig) of ``dist-gspmd``'s train step: OLMoE-1B-7B
    at full width, DIST_GSPMD_TRAIN_LAYERS, fp32, remat "full", the plain
    torch route with K1 for the projections, one AdamW step."""
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainConfig
    cfg = _cut(MOE_ARCH, DIST_GSPMD_TRAIN_LAYERS, dtype=torch.float32,
               backend="torch", moe_shard_map=False)
    return cfg, TrainConfig(
        optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        loss_chunk=DIST_TRAIN_FP32_BATCH[1])


def _dist_gspmd_rank(world, out_dir: str) -> None:
    """One rank of phase ``dist-gspmd``, spawned by ``run_world``: OLMoE
    served on (data 2, model 2) under GSPMD expert parallelism, each of
    ``_gspmd_configs``, the rank's 2 rows of the serve traffic's first
    batch, held to the parent's one-process runs (``gspmd_one.pt``).
    Each rank builds the whole model on the card in its turn and keeps its
    shards; a run's peak is the process's less cuBLAS's workspace (taken
    first and measured).  Then takes the train step of
    ``_gspmd_train_config`` under GSPMD_RULES, held to the parent's one
    process under the abstract mesh (``gspmd_train_mu.pt``) and off it.
    Prints a dist-gspmd-fp32, a dist-gspmd-bf16, a dist-gspmd-every-fp32
    and a dist-gspmd-train line, raises on a failed check (which fails
    the world) and writes its launch counts to
    ``out_dir/gspmd_rank{r}.json``."""
    import torch.distributed as dist
    from repro_torch.core import tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import collectives, logical, sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, rank_view
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import make_decode, make_prefill
    from repro_torch.training.train_step import make_train_step
    global _EMIT_LOCK
    disable_tf32()
    out_dir, r = Path(out_dir), world.rank
    _EMIT_LOCK = out_dir / "emit.lock"
    one = torch.load(out_dir / "gspmd_one.pt")
    head = {"rank": r, "world": world.size, "backend": world.backend,
            "backend_reason": world.reason, "device": str(world.device)}
    mesh = make_mesh(DIST_GSPMD_MESH, ("data", "model"))
    view = rank_view(DIST_GSPMD_MESH, mesh.axis_names, mesh.coordinate)
    n = MAX_BATCH // DIST_GSPMD_MESH[0]
    rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)
    s = int(max(prompt_lengths()[0][:MAX_BATCH]))
    launches = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.ones((8, 8), device="cuda") @ torch.ones((8, 8), device="cuda")
    torch.cuda.synchronize()
    workspace = torch.cuda.memory_allocated() - base
    inner_capacity = moe_lib.moe_capacity

    def built(cfg, rules):
        """The rank's shards of the seeded model, each rank in its turn."""
        mod = family_module(cfg)
        for turn in range(world.size):
            if turn == r:
                whole = mod.init(cfg, torch.Generator(
                    device="cuda").manual_seed(DIST_SEED), "cuda")
                params = sharding.shard_params(whole, mesh, rules,
                                               glu=cfg.mlp_glu)
                del whole
                torch.cuda.empty_cache()
            dist.barrier()
        return params

    for tag, cfg, rules in _gspmd_configs():
        mod = family_module(cfg)
        every = rules is GSPMD_EVERY_RULES
        params = built(cfg, rules)
        wi = params["layers"][0]["moe"]["experts_wi"]
        cache = sharding.shard_cache(mod.init_cache(
            cfg, MAX_BATCH, CACHE_LEN, device="cuda"), mesh, cfg, rules)
        ref = one["fp32" if every else tag]
        capacities = []

        def capacity(c, tokens):
            capacities.append(inner_capacity(c, tokens))
            return capacities[-1]
        read = _counted(_moe_wrappers())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        moe_lib.moe_capacity = capacity
        try:
            with logical.use_rules(mesh, rules):
                got = _mesh_serve(cfg, params, cache,
                                  follow=ref["greedy"][:, :-1], rows=rows)
        finally:
            moe_lib.moe_capacity = inner_capacity
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - workspace
        counts = read()
        mine = [x[rows] for x in ref["logits"]]
        errs = [rel_err(a, b)[0] for a, b in zip(got["logits"], mine)]
        agree = float((got["greedy"] == ref["greedy"][rows]).float().mean())
        line = {}
        if tag == "bf16":
            line["logits_bit_identical_to_ranks_in_turn"] = all(
                torch.equal(a, b) for a, b in zip(got["logits"], mine))
            line["vs_all_experts_at_once_rel_err"] = [
                rel_err(a, b[rows])[0] for a, b in
                zip(got["logits"], one["bf16-all"]["logits"])]
        # one more decode step, counted on the card and on meta at this
        # rank's coordinate; the serve steps' peak against the meta trace
        tok = ref["greedy"][rows, -1:].to("cuda", torch.int32)
        pos = s + DIST_TP_DECODE
        with logical.use_rules(mesh, rules):
            card, _, _ = dryrun.count_step(make_decode(cfg), (
                params, tok, got["cache"], pos), False)
        with logical.use_rules(view, rules):
            meta_params = sharding.shard_params(
                mod.init(cfg, None, "meta"), view, rules, glu=cfg.mlp_glu)
            meta_cache = sharding.shard_cache(mod.init_cache(
                cfg, MAX_BATCH, CACHE_LEN, device="meta"), view, cfg, rules)
            tokens = torch.empty((n, s), dtype=torch.int32, device="meta")
            pre, _, _ = dryrun.count_step(make_prefill(cfg), (
                meta_params, {"tokens": tokens}, meta_cache), False)
            meta, _, _ = dryrun.count_step(make_decode(cfg), (
                meta_params, tokens[:, :1], meta_cache, pos), False)
        mem = {"arguments": dryrun.tree_bytes((meta_params, meta_cache,
                                                tokens)),
               "temp_meta": max(pre.temp_bytes, meta.temp_bytes)}
        mem["total"] = mem["arguments"] + mem["temp_meta"]
        counted = {**{k: float(x) for k, x in card.per_collective.items()},
                   "total": card.collective_bytes}
        reckoned = _gspmd_decode_collectives(
            cfg, dict(mesh.shape), n, rules is not GSPMD_WHOLE_RULES, every)
        kernels = _gspmd_serve_launches(cfg, DIST_TP_DECODE)
        e_axes = ("data", "model") if every else ("data",)
        want_caps = [moe_lib.moe_capacity(cfg, MAX_BATCH * s)] * cfg.n_layers \
            + [moe_lib.moe_capacity(cfg, MAX_BATCH)] * (
                cfg.n_layers * DIST_TP_DECODE)
        phase = f"dist-gspmd-{tag}"
        emit({"phase": phase, **head, **counts,
              "config": f"{MOE_ARCH} full width, {cfg.n_layers} layers, "
                        f"{str(cfg.dtype)[6:]}, moe_shard_map=False, (data "
                        f"{DIST_GSPMD_MESH[0]}, model {DIST_GSPMD_MESH[1]}),"
                        f" rules {rules}: experts "
                        f"[{sharding.block_index(mesh, e_axes) * wi.shape[1]}"
                        f", +{wi.shape[1]}) of {cfg.moe.n_experts}, each "
                        f"with {wi.shape[-1] // 2} of its "
                        f"{cfg.moe.d_ff_expert} d_ff columns; rows {rows.start}"
                        f"-{rows.stop - 1} of {MAX_BATCH}",
              "held_against": ("one process, the ranks' partials in turn "
                               "under an abstract mesh" if tag == "bf16"
                               else "one process off the mesh"),
              "logits_rel_err": errs,
              "tol": 0.0 if tag == "bf16" else TOL_FP32, **line,
              "greedy_tokens_agree": agree,
              "moe_capacities": sorted(set(capacities)),
              "launches_reckoned": kernels,
              "collective_bytes_decode_step": counted,
              "collective_bytes_meta": meta.per_collective,
              "collective_bytes_reckoned": reckoned,
              "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
              "one_process_prefill_ms": ref["prefill_ms"],
              "one_process_decode_ms": ref["decode_ms"],
              "max_memory_allocated": peak, "cublas_workspace": workspace,
              "memory_reckoned": mem,
              "memory_rel": peak / mem["total"] - 1.0,
              "tol_memory": TOL_DIST_MEMORY})
        require(all(bool(torch.isfinite(x).all()) for x in got["logits"]),
                f"{phase}: logits not finite")
        want_wi = ((cfg.moe.n_experts // mesh.size, cfg.d_model,
                    2 * cfg.moe.d_ff_expert) if every else
                   (cfg.moe.n_experts // DIST_GSPMD_MESH[0], cfg.d_model,
                    2 * cfg.moe.d_ff_expert // DIST_GSPMD_MESH[1]))
        require(tuple(wi.shape[1:]) == want_wi,
                f"{phase}: a rank's experts_wi {tuple(wi.shape)}")
        if tag != "bf16":
            require(all(e_ <= TOL_FP32 for e_ in errs),
                    f"{phase}: logits {errs} against {TOL_FP32}")
        else:
            require(line["logits_bit_identical_to_ranks_in_turn"],
                    f"{phase}: logits {errs} differ from the ranks' "
                    "partials in turn")
        require(agree == 1.0, f"{phase}: greedy tokens differ from one "
                "process's")
        require(capacities == want_caps, f"{phase}: capacities "
                f"{sorted(set(capacities))}, the whole batch's "
                f"{sorted(set(want_caps))}")
        require({k: counts[k] for k in kernels} == kernels,
                f"{phase}: launches {counts}, reckoned {kernels}")
        require(counted == reckoned and card.per_collective
                == meta.per_collective, f"{phase}: a decode step's "
                f"collective bytes {counted}, meta {meta.per_collective}, "
                f"reckoned {reckoned}")
        require(abs(peak / mem["total"] - 1.0) <= TOL_DIST_MEMORY,
                f"{phase}: peak {peak} B against {mem['total']} B reckoned")
        launches[phase] = counts
        del params, cache, got, card, meta, pre, meta_params, meta_cache, wi
        torch.cuda.empty_cache()

    # one fp32 AdamW step under GSPMD_RULES
    cfg, tcfg = _gspmd_train_config()
    sizes = dict(mesh.shape)
    params = built(cfg, GSPMD_RULES)
    opt = adamw.init(tcfg.optimizer, params)
    batch = sharding.local_batch(train_batch(
        cfg, *DIST_TRAIN_FP32_BATCH, "cuda"), mesh)
    read = _counted(_moe_wrappers())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with logical.use_rules(mesh, GSPMD_RULES):
        card, (_, opt, metrics, _), step_s = dryrun.count_step(
            make_train_step(cfg, tcfg), (params, opt, batch), True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - workspace
    counts = read()
    with logical.use_rules(view, GSPMD_RULES):
        mp = sharding.shard_params(family_module(cfg).init(
            cfg, None, "meta"), view, GSPMD_RULES, glu=cfg.mlp_glu)
        meta_args = (mp, adamw.init(tcfg.optimizer, mp),
                     {k: torch.empty(x.shape, dtype=x.dtype, device="meta")
                      for k, x in batch.items()})
        meta, _, _ = dryrun.count_step(make_train_step(cfg, tcfg),
                                       meta_args, True)
    mem = {"arguments": dryrun.tree_bytes(meta_args),
           "temp_meta": meta.temp_bytes}
    mem["total"] = mem["arguments"] + mem["temp_meta"]
    ref = one["train"]
    ref_mu = sharding.shard_params(
        torch.load(out_dir / "gspmd_train_mu.pt", mmap=True), mesh,
        GSPMD_RULES, glu=cfg.mlp_glu)
    worst = torch.stack([(a - b.cuda()).abs().max().float() for a, b in
                         zip(tree.leaves(opt["mu"]), tree.leaves(ref_mu))])
    collectives.all_reduce(worst, op="max")
    grad_rel = (worst.cpu() / torch.tensor(ref["mu_max"])).tolist()
    loss = float(metrics["loss"])
    loss_rel = {run: abs(loss - ref[f"loss_{run}"]) / abs(ref[f"loss_{run}"])
                for run in ("in_turn", "off")}
    counted = {**{k: float(x) for k, x in card.per_collective.items()},
               "total": card.collective_bytes}
    reckoned = _gspmd_train_collectives(cfg, sizes, batch["tokens"].shape[0],
                                        DIST_TRAIN_FP32_BATCH[1])
    phase = "dist-gspmd-train"
    emit({"phase": phase, **head, **counts,
          "config": f"{MOE_ARCH} full width, {cfg.n_layers} layers, fp32, "
                    f"remat {cfg.remat}, moe_shard_map=False, (data "
                    f"{DIST_GSPMD_MESH[0]}, model {DIST_GSPMD_MESH[1]}), "
                    f"rules {GSPMD_RULES}, batch {DIST_TRAIN_FP32_BATCH}",
          "loss": loss, "in_turn_loss": ref["loss_in_turn"],
          "off_mesh_loss": ref["loss_off"], "loss_rel": loss_rel,
          "tol_loss": TOL_TRAIN_LOSS, "mu_rel_max": max(grad_rel),
          "mu_rel_by_leaf": grad_rel,
          "in_turn_vs_off_mesh_mu_rel_max": ref["in_turn_vs_off_mu_rel"],
          "tol_grad": TOL_TRAIN_GRAD,
          "collective_bytes_step": counted,
          "collective_bytes_meta": meta.per_collective,
          "collective_bytes_reckoned": reckoned,
          "step_s_host_counted": step_s,
          "max_memory_allocated": peak, "cublas_workspace": workspace,
          "memory_reckoned": mem, "memory_rel": peak / mem["total"] - 1.0,
          "tol_memory": TOL_DIST_MEMORY})
    require(max(loss_rel.values()) <= TOL_TRAIN_LOSS, f"{phase}: loss "
            f"{loss} against {ref['loss_in_turn']} in turn and "
            f"{ref['loss_off']} off the mesh")
    require(max(grad_rel) <= TOL_TRAIN_GRAD and ref["in_turn_vs_off_mu_rel"]
            <= TOL_TRAIN_GRAD, f"{phase}: first moment {max(grad_rel)} of "
            f"a leaf's max from the ranks in turn, which lie "
            f"{ref['in_turn_vs_off_mu_rel']} from off the mesh")
    require(counts["fused_matmul"] > 0 and counts["grouped_matmul"] == 0
            and counts["flash_attention"] == 0, f"{phase}: launches {counts}")
    require(counted == reckoned and card.per_collective
            == meta.per_collective, f"{phase}: a step's collective bytes "
            f"{counted}, meta {meta.per_collective}, reckoned {reckoned}")
    require(abs(peak / mem["total"] - 1.0) <= TOL_DIST_MEMORY,
            f"{phase}: peak {peak} B against {mem['total']} B reckoned")
    launches[phase] = counts
    del params, opt, ref_mu, metrics, card, meta, mp, meta_args
    torch.cuda.empty_cache()
    (out_dir / f"gspmd_rank{r}.json").write_text(json.dumps(
        {"world": head, "launches": launches}))


def phase_dist_gspmd():
    """OLMoE-1B-7B served under GSPMD expert parallelism on
    DIST_GSPMD_RANKS ranks of (data 2, model 2) through
    ``launch.mesh.run_world`` (gloo: the ranks share the card;
    ``_dist_gspmd_rank``).  First, in this process, what the ranks are
    held to: the fp32 run off the mesh (the reference's function: one
    routing of the whole batch, all experts at once), and the bf16 run
    under an abstract mesh with GSPMD_WHOLE_RULES (every rank's partial
    in turn, summed as the ranks sum them) and off the mesh on its tokens
    (the distance reported); the train step under the abstract mesh and
    off it.  A rank that fails, or a world that outlives
    DIST_GSPMD_TIMEOUT, fails the phase."""
    import shutil

    from repro_torch.core import tree
    from repro_torch.distributed import logical
    from repro_torch.launch.mesh import abstract_mesh, run_world
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import make_train_step
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    one = {}
    in_turn = abstract_mesh(DIST_GSPMD_MESH, ("data", "model"))
    for tag, cfg, rules in _gspmd_configs():
        if rules is GSPMD_EVERY_RULES:          # held to the fp32 run's
            continue
        mod = family_module(cfg)
        params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(
            DIST_SEED), "cuda")
        runs = ((tag, None),) if tag == "fp32" else (
            (tag, in_turn), ("bf16-all", None))
        for run, mesh in runs:
            cache = mod.init_cache(cfg, MAX_BATCH, CACHE_LEN, device="cuda")
            follow = one[tag]["greedy"][:, :-1] if run != tag else None
            with (logical.use_rules(mesh, rules) if mesh is not None
                  else contextlib.nullcontext()):
                got = _mesh_serve(cfg, params, cache, follow)
            got.pop("cache")
            got.pop("batch")
            one[run] = got
            del cache
        del params
        torch.cuda.empty_cache()
    # the train step in one process: under the abstract mesh (the ranks'
    # partials in turn; its first moment saved for the ranks) and off it
    cfg, tcfg = _gspmd_train_config()
    train, mus = {}, {}
    for run, mesh in (("in_turn", in_turn), ("off", None)):
        params = family_module(cfg).init(cfg, torch.Generator(
            device="cuda").manual_seed(DIST_SEED), "cuda")
        with logical.use_rules(mesh, GSPMD_RULES):
            _, opt, metrics, _ = make_train_step(cfg, tcfg)(
                params, adamw.init(tcfg.optimizer, params),
                train_batch(cfg, *DIST_TRAIN_FP32_BATCH, "cuda"))
        train[f"loss_{run}"] = float(metrics["loss"])
        mus[run] = tree.tree_map(lambda x: x.cpu(), opt["mu"])
        del params, opt, metrics
        torch.cuda.empty_cache()
    pairs = list(zip(tree.leaves(mus["in_turn"]), tree.leaves(mus["off"])))
    train["mu_max"] = [float(a.abs().max()) for a, _ in pairs]
    train["in_turn_vs_off_mu_rel"] = max(
        float((a - b).abs().max() / b.abs().max()) for a, b in pairs)
    one["train"] = train
    torch.save(mus["in_turn"], DIST_DIR / "gspmd_train_mu.pt")
    del mus, pairs
    torch.save(one, DIST_DIR / "gspmd_one.pt")
    one_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    try:
        run_world(_dist_gspmd_rank, DIST_GSPMD_RANKS, (str(DIST_DIR),),
                  rendezvous=str(DIST_DIR / "rendezvous"),
                  timeout=DIST_GSPMD_TIMEOUT)
    except Exception as e:                   # a rank failed or hung
        raise PhaseFailed(f"dist-gspmd: {type(e).__name__}: {e}") from None
    world_s = time.perf_counter() - t0
    ranks = [json.loads((DIST_DIR / f"gspmd_rank{i}.json").read_text())
             for i in range(DIST_GSPMD_RANKS)]
    launches = {f"{path}/rank{i}": counts for i, got in enumerate(ranks)
                for path, counts in got["launches"].items()}
    emit({"phase": "dist-gspmd", "ranks": DIST_GSPMD_RANKS,
          "backend": ranks[0]["world"]["backend"],
          "backend_reason": ranks[0]["world"]["backend_reason"],
          "one_process_s": one_s, "world_wall_s": world_s,
          "wall_s": time.perf_counter() - t_phase, "launches": launches})
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Sequence parallelism for every family: the residual stream between
# blocks the rank's share of the sequence, gathered at each block's entry
# and reduce-scattered at its exit.
# ---------------------------------------------------------------------------

def _sp_batch(cfg):
    """dist-sp's serving batch: 4 prompts of DIST_SP_PROMPT seeded tokens
    (numpy seed 0) after the model's vision prefix, with seeded stub
    frontend inputs."""
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        MAX_BATCH, cfg.vision_prefix + DIST_SP_PROMPT))).to(
            device="cuda", dtype=torch.int32)
    return {"tokens": tokens, **stub_inputs(cfg, MAX_BATCH, torch.Generator(
        device="cuda").manual_seed(DIST_SEED))}


def _sp_train_batch(cfg):
    """dist-sp's train batch: DIST_TRAIN_FP32_BATCH's rows of its tokens
    after the model's vision prefix (whose labels the loss masks), with
    seeded prefix embeddings where the model has one."""
    b, s = DIST_TRAIN_FP32_BATCH
    batch = train_batch(cfg, b, cfg.vision_prefix + s, "cuda")
    if cfg.vision_prefix:
        batch.update(stub_inputs(cfg, DIST_TRAIN_FP32_BATCH[0],
                                 torch.Generator(device="cuda").manual_seed(
                                     DIST_SEED)))
    return batch


def _sp_serve_configs():
    """(tag, config, mesh shape, rules) of dist-sp's fp32 serving runs:
    each family at DIST_SP_FP32_LAYERS on (data 1, model DIST_SP_RANKS)
    under SP_RULES, then OLMoE's GSPMD form on (data 2, model 2)."""
    out = [(f"{arch}-fp32", _cut(arch, n, dtype=torch.float32,
                                 kv_cache_dtype=torch.float32),
            (1, DIST_SP_RANKS), SP_RULES)
           for arch, n in DIST_SP_FP32_LAYERS.items()]
    olmoe = _cut(MOE_ARCH, DIST_SP_FP32_LAYERS[MOE_ARCH],
                 dtype=torch.float32, kv_cache_dtype=torch.float32)
    return out + [(f"{MOE_ARCH}-gspmd-fp32", olmoe.with_(
        moe_shard_map=False), DIST_GSPMD_MESH, {**GSPMD_RULES, **SP_RULES})]


def _sp_train_config(arch):
    """(config, TrainConfig) of a dist-sp train step: ``arch`` at full
    width, DIST_SP_TRAIN_LAYERS, fp32, remat "full", the plain torch
    route with K1 for the projections, one AdamW step."""
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainConfig
    cfg = _cut(arch, DIST_SP_TRAIN_LAYERS[arch], dtype=torch.float32,
               backend="torch")
    return cfg, TrainConfig(
        optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        loss_chunk=DIST_TRAIN_FP32_BATCH[1])


def _sp_serve_launches(cfg, k1_prefill: int, k1_decode: int,
                       model: int) -> dict:
    """K1's, K2's, K4's, K5's and K6's launches by tile on one rank of
    dist-sp serving the batch and DIST_TP_DECODE decode steps.  K1: the
    meta count's calls of a prefill (``k1_prefill``) and of a decode step
    (``k1_decode``), a prefill's on the tensor-core tile in bf16 and the
    SIMT tile in fp32 but its logits (M = the rank's rows, the decode
    tile), a decode step's on the decode tile.  K2: one prefill call an
    attention layer and a pass (Griffin's two passes; Whisper's encoder,
    decoder self- and cross-attention, and a cross-attention call each
    decode step where its cache is held whole over ``model``).  K4: both
    expert GEMMs a layer, a prefill's at its capacity on the big tile, a
    decode step's (capacity 8) on the decode tile.  K5: Griffin's
    recurrent layers in both prefill passes.  K6: one call a layer at
    prefill.  A decode step's attention, RG-LRU and WKV are plain ops."""
    big = "tc" if cfg.dtype == torch.bfloat16 else "simt"
    steps, n = DIST_TP_DECODE, cfg.n_layers

    def tiles(count, decode=0, names=("tc", "simt")):
        out = dict.fromkeys(names, 0)
        out[big] += count
        if decode:
            out["decode"] = decode
        return out
    out = {"fused_matmul_by_tile": {"tc": 0, "simt": 0,
                                    "decode": 1 + steps * k1_decode}}
    out["fused_matmul_by_tile"][big] += k1_prefill - 1
    if cfg.family == "griffin":
        pat = cfg.rnn.block_pattern
        n_attn = sum(1 for i in range(n) if pat[i % len(pat)] == "attn")
        out["flash_attention_by_tile"] = tiles(2 * n_attn)
        out["rglru_scan"] = 2 * (n - n_attn)
    elif cfg.family == "rwkv6":
        out["rwkv6_scan_by_tile"] = tiles(n)
    elif cfg.family == "encdec":
        whole = cfg.encdec.n_audio_ctx % model != 0
        out["flash_attention_by_tile"] = tiles(
            cfg.encdec.n_encoder_layers + 2 * n + (steps * n if whole
                                                   else 0))
    else:
        out["flash_attention_by_tile"] = tiles(n)
        if cfg.moe is not None:
            out["grouped_matmul_by_tile"] = tiles(
                2 * n, 2 * n * steps, ("tc", "simt", "decode"))
    return out


def _sp_prefill_scatter(cfg, sizes: dict, rows: int, s: int) -> float:
    """The reduce-scatter bytes of one fp32 prefill on a rank of dist-sp
    (``rows`` rows of ``s`` tokens on a mesh of ``sizes``): every exit of
    a pass over a sequence that ``model`` divides hands the rank its
    share, rows x s / model x d x 4 bytes: the embedding's and each
    row-parallel projection's (a layer's two; Griffin's in both passes,
    its second over the window's tail; Whisper's encoder two a layer over
    its frames, its decoder three); OLMoE's GSPMD form adds each MoE
    layer's fp32 partial over data (the rank's rows of the whole
    sequence) before its share over model."""
    d, n, m = cfg.d_model, cfg.n_layers, sizes.get("model", 1)

    def exits(count, length):
        return count * rows * length // m * d * 4 if length % m == 0 else 0
    if cfg.family == "griffin":
        return float(exits(2 * n + 1, s) + exits(2 * n + 1,
                                                  min(cfg.window, s)))
    if cfg.family == "encdec":
        return float(exits(2 * cfg.encdec.n_encoder_layers,
                           cfg.encdec.n_audio_ctx) + exits(3 * n + 1, s))
    if cfg.moe is not None and not cfg.moe_shard_map:
        return float(exits(n + 1, s) + n * rows * s * d * 4 * (
            sizes.get("data", 1) > 1) + exits(n, s))
    return float(exits(2 * n + 1, s))


def _dist_sp_rank(world, out_dir: str) -> None:
    """One rank of phase ``dist-sp``, spawned by ``run_world``: serves
    each of ``_sp_serve_configs`` under its rules, held to the parent's
    one-process runs (``sp_one.pt``), then each family in bf16
    (DIST_SP_BF16_LAYERS) with and without SP_RULES on the same mesh,
    and takes each
    family's train step on (data 2, model 2) under SP_RULES, held to the
    parent's one-rank steps; checks K5 and K6 at its shapes.  Each rank
    builds a whole model on the card in its turn and keeps its shards.
    Prints a dist-sp-serve line a fp32 run, a dist-sp-bf16 line a family,
    a dist-sp-train line a family and a dist-sp-kernels line, raises on a
    failed check (which fails the world) and writes its launch counts and
    times to ``out_dir/sp_rank{r}.json``."""
    import torch.distributed as dist
    from repro_torch.core import tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import collectives, logical, sharding
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, rank_view
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import make_decode, make_prefill
    from repro_torch.training.train_step import make_train_step
    global _EMIT_LOCK
    disable_tf32()
    out_dir, r = Path(out_dir), world.rank
    _EMIT_LOCK = out_dir / "emit.lock"
    one = torch.load(out_dir / "sp_one.pt")
    head = {"rank": r, "world": world.size, "backend": world.backend,
            "backend_reason": world.reason, "device": str(world.device)}
    wrappers = {"fused_matmul": fused_matmul,
                "flash_attention": flash_attention,
                "grouped_matmul": grouped_matmul,
                "rglru_scan": rglru_scan, "rwkv6_scan": rwkv6_scan}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:                 # every rank makes each
            meshes[shape] = make_mesh(shape, ("data", "model"))
        return meshes[shape]
    launches, times = {}, {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.ones((8, 8), device="cuda") @ torch.ones((8, 8), device="cuda")
    torch.cuda.synchronize()
    workspace = torch.cuda.memory_allocated() - base

    def built(cfg, mesh_, rules):
        """The rank's shards of the seeded model, each rank in its turn."""
        mod = family_module(cfg)
        for turn in range(world.size):
            if turn == r:
                whole = mod.init(cfg, torch.Generator(
                    device="cuda").manual_seed(DIST_SEED), "cuda")
                params = sharding.shard_params(whole, mesh_, rules,
                                               glu=cfg.mlp_glu)
                del whole
                torch.cuda.empty_cache()
            dist.barrier()
        return params

    def rows_of(mesh_):
        n = MAX_BATCH // mesh_.shape["data"]
        return slice(mesh_.index("data") * n, (mesh_.index("data") + 1) * n)

    for tag, cfg, shape, rules in _sp_serve_configs():
        mod, mesh = family_module(cfg), mesh_of(shape)
        view = rank_view(tuple(mesh.shape.values()), mesh.axis_names,
                         mesh.coordinate)
        cache_len = DIST_SP_CACHE.get(cfg.name, 512)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        params = built(cfg, mesh, rules)
        cache = sharding.shard_cache(mod.init_cache(
            cfg, MAX_BATCH, cache_len, device="cuda"), mesh, cfg, rules)
        ref = one[f"serve-{cfg.name}"]
        rows = rows_of(mesh)
        batch = _sp_batch(cfg)
        read = _counted(wrappers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with logical.use_rules(mesh, rules):
            got = _mesh_serve(cfg, params, cache,
                              follow=ref["greedy"][:, :-1], rows=rows,
                              batch=batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - workspace
        counts = read()
        errs = [rel_err(a, b[rows])[0] for a, b in zip(got["logits"],
                                                       ref["logits"])]
        agree = float((got["greedy"] == ref["greedy"][rows]).float().mean())
        whole = sharding.gather_cache(got["cache"], mesh, cfg, rules)
        cache_err = max(rel_err(a.cpu(), b)[0] for a, b in zip(
            tree.leaves(whole), tree.leaves(ref["cache"])))
        del whole
        # the prefill counted again on the card, and on meta at this
        # rank's coordinate with a decode step; the serve's peak against
        # the meta trace
        lb = got["batch"]
        with logical.use_rules(mesh, rules):
            card, _, _ = dryrun.count_step(make_prefill(cfg), (
                params, lb, got["cache"]), False)
        with logical.use_rules(view, rules):
            meta_params = sharding.shard_params(
                mod.init(cfg, None, "meta"), view, rules, glu=cfg.mlp_glu)
            meta_cache = sharding.shard_cache(mod.init_cache(
                cfg, MAX_BATCH, cache_len, device="meta"), view, cfg, rules)
            mb = {k: torch.empty(x.shape, dtype=x.dtype, device="meta")
                  for k, x in lb.items()}
            pre, _, _ = dryrun.count_step(make_prefill(cfg), (
                meta_params, mb, meta_cache), False)
            dec, _, _ = dryrun.count_step(make_decode(cfg), (
                meta_params, mb["tokens"][:, :1], meta_cache,
                lb["tokens"].shape[1]), False)
        mem = {"arguments": dryrun.tree_bytes((meta_params, meta_cache, mb)),
               "temp_meta": max(pre.temp_bytes, dec.temp_bytes)}
        mem["total"] = mem["arguments"] + mem["temp_meta"]
        counted = {**{k: float(x) for k, x in card.per_collective.items()},
                   "total": card.collective_bytes}
        scatter = _sp_prefill_scatter(cfg, dict(mesh.shape),
                                      lb["tokens"].shape[0],
                                      lb["tokens"].shape[1])
        kernels = _sp_serve_launches(
            cfg, pre.kernels["fused_matmul"]["calls"],
            dec.kernels["fused_matmul"]["calls"], mesh.shape["model"])
        phase = "dist-sp-serve"
        emit({"phase": phase, **head, "run": tag, **counts,
              "config": f"{cfg.name} full width, {cfg.n_layers} layers, "
                        f"fp32, (data {shape[0]}, model {shape[1]}), rules "
                        f"{rules}, {MAX_BATCH} x {batch['tokens'].shape[1]}"
                        f" tokens, cache {cache_len}",
              "logits_rel_err": errs, "tol": TOL_FP32,
              "cache_rel_err": cache_err, "greedy_tokens_agree": agree,
              "launches_reckoned": kernels,
              "collective_bytes_prefill": counted,
              "collective_bytes_meta": pre.per_collective,
              "reduce_scatter_reckoned": scatter,
              "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
              "one_process_prefill_ms": ref["prefill_ms"],
              "one_process_decode_ms": ref["decode_ms"],
              "max_memory_allocated": peak, "held_before_run": held,
              "cublas_workspace": workspace, "memory_reckoned": mem,
              "memory_rel": peak / mem["total"] - 1.0,
              "tol_memory": TOL_DIST_MEMORY})
        require(all(bool(torch.isfinite(x).all()) for x in got["logits"]),
                f"{phase} {tag}: logits not finite")
        require(all(e_ <= TOL_FP32 for e_ in errs),
                f"{phase} {tag}: logits {errs} against {TOL_FP32}")
        require(agree == 1.0, f"{phase} {tag}: greedy tokens differ from "
                "one process's")
        require(cache_err <= TOL_FP32, f"{phase} {tag}: gathered cache "
                f"{cache_err} from one process's")
        got_tiles = {k: counts[k] for k in kernels}
        require(got_tiles == kernels, f"{phase} {tag}: launches "
                f"{got_tiles}, reckoned {kernels}")
        require(counted.get("reduce-scatter") == scatter and
                card.per_collective == pre.per_collective,
                f"{phase} {tag}: a prefill's collective bytes {counted}, "
                f"meta {pre.per_collective}, reduce-scatter reckoned "
                f"{scatter}")
        require(abs(peak / mem["total"] - 1.0) <= TOL_DIST_MEMORY,
                f"{phase} {tag}: peak {peak} B against {mem['total']} B "
                "reckoned")
        launches[f"dist-sp-{tag}"] = counts
        times[tag] = {"prefill_ms": got["prefill_ms"],
                      "decode_ms": got["decode_ms"]}
        del params, cache, got, card, pre, dec, meta_params, meta_cache
        torch.cuda.empty_cache()

    # each family in bf16 at DIST_SP_BF16_LAYERS, on the same mesh with
    # and without the seq rule, the first run's greedy tokens fed to both
    mesh = mesh_of((1, DIST_SP_RANKS))
    for arch, layers in DIST_SP_BF16_LAYERS.items():
        cfg = _cut(arch, layers)
        mod = family_module(cfg)
        params = built(cfg, mesh, None)
        batch = _sp_batch(cfg)
        runs = {}
        for run, rules in (("whole", None), ("seq", SP_RULES)):
            cache = sharding.shard_cache(mod.init_cache(
                cfg, MAX_BATCH, DIST_SP_CACHE.get(arch, 512),
                device="cuda"), mesh, cfg, rules)
            follow = runs["whole"]["greedy"][:, :-1] if runs else None
            read = _counted(wrappers)
            with logical.use_rules(mesh, rules):
                runs[run] = _mesh_serve(cfg, params, cache, follow=follow,
                                        batch=batch)
            runs[run]["counts"] = read()
            del cache
        counts = runs["seq"]["counts"]
        same = all(torch.equal(a, b) for a, b in zip(
            runs["seq"]["logits"], runs["whole"]["logits"]))
        errs = [rel_err(a, b)[0] for a, b in zip(runs["seq"]["logits"],
                                                 runs["whole"]["logits"])]
        agree = float((runs["seq"]["greedy"] == runs["whole"]["greedy"])
                      .float().mean())
        kernels = _sp_serve_launches(cfg, 1, 0, mesh.shape["model"])
        kernels.pop("fused_matmul_by_tile")
        gloo = world.backend == "gloo"
        emit({"phase": "dist-sp-bf16", **head, "run": arch, **counts,
              "config": f"{arch} full width, {cfg.n_layers} layers, bf16, "
                        f"(data 1, model {DIST_SP_RANKS}), rules {SP_RULES} "
                        "against none",
              "bit_identical": same, "logits_rel_err": errs,
              "held": "bit for bit" if gloo else f"TOL_PATH_BF16 "
                                                 f"{TOL_PATH_BF16}",
              "greedy_tokens_agree": agree, "launches_reckoned": kernels,
              "prefill_ms": runs["seq"]["prefill_ms"],
              "decode_ms": runs["seq"]["decode_ms"],
              "no_seq_prefill_ms": runs["whole"]["prefill_ms"],
              "no_seq_decode_ms": runs["whole"]["decode_ms"]})
        require(same if gloo else max(errs) <= TOL_PATH_BF16,
                f"dist-sp-bf16 {arch}: logits {errs} from the run without "
                "the seq rule")
        got_tiles = {k: counts[k] for k in kernels}
        require(got_tiles == kernels and counts["fused_matmul"] > 0,
                f"dist-sp-bf16 {arch}: launches {got_tiles}, reckoned "
                f"{kernels}")
        launches[f"dist-sp-bf16-{arch}"] = counts
        times[f"{arch}-bf16"] = {
            "prefill_ms": runs["seq"]["prefill_ms"],
            "decode_ms": runs["seq"]["decode_ms"],
            "no_seq_prefill_ms": runs["whole"]["prefill_ms"],
            "no_seq_decode_ms": runs["whole"]["decode_ms"]}
        del params, runs
        torch.cuda.empty_cache()

    # one fp32 AdamW step of each family on (data 2, model 2)
    train_mesh = mesh_of((2, 2))
    view = rank_view((2, 2), ("data", "model"), train_mesh.coordinate)
    for arch in DIST_SP_TRAIN_LAYERS:
        cfg, tcfg = _sp_train_config(arch)
        params = built(cfg, train_mesh, SP_RULES)
        opt = adamw.init(tcfg.optimizer, params)
        batch = _sp_train_batch(cfg)
        read = _counted(wrappers)
        with logical.use_rules(train_mesh, SP_RULES):
            card, (_, opt, metrics, _), _ = dryrun.count_step(
                make_train_step(cfg, tcfg), (params, opt, sharding.
                                             local_batch(batch, train_mesh)),
                True)
        counts = read()
        meta = {}
        for run, rules in (("seq", SP_RULES), ("whole", None)):
            with logical.use_rules(view, rules):
                mp = sharding.shard_params(family_module(cfg).init(
                    cfg, None, "meta"), view, rules, glu=cfg.mlp_glu)
                mbatch = {k: torch.empty(x.shape, dtype=x.dtype,
                                         device="meta") for k, x in
                          sharding.local_batch(batch, view).items()}
                meta[run], _, _ = dryrun.count_step(
                    make_train_step(cfg, tcfg), (
                        mp, adamw.init(tcfg.optimizer, mp), mbatch), True)
        ref = one[f"train-{arch}"]
        ref_mu = sharding.shard_params(
            torch.load(out_dir / f"sp_train_mu_{arch}.pt", mmap=True),
            train_mesh, SP_RULES, glu=cfg.mlp_glu)
        worst = torch.stack([(a - b.cuda()).abs().max().float() for a, b in
                             zip(tree.leaves(opt["mu"]),
                                 tree.leaves(ref_mu))])
        collectives.all_reduce(worst, op="max")
        grad_rel = (worst.cpu() / torch.tensor(ref["mu_max"])).tolist()
        loss = float(metrics["loss"])
        loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        tol_grad = TOL_TRAIN_GRAD
        scatter = {run: m.per_collective.get("reduce-scatter", 0.0)
                   for run, m in meta.items()}
        emit({"phase": "dist-sp-train", **head, **counts,
              "config": f"{arch} full width, {cfg.n_layers} layers, fp32, "
                        f"(data 2, model 2), rules {SP_RULES}, batch "
                        f"{DIST_TRAIN_FP32_BATCH}",
              "loss": loss, "one_rank_loss": ref["loss"],
              "loss_rel": loss_rel, "tol_loss": TOL_TRAIN_LOSS,
              "mu_rel_max": max(grad_rel), "tol_grad": tol_grad,
              "collective_bytes_step": card.per_collective,
              "collective_bytes_meta": meta["seq"].per_collective,
              "collective_bytes_meta_without_seq":
                  meta["whole"].per_collective})
        require(loss_rel <= TOL_TRAIN_LOSS, f"dist-sp-train {arch}: loss "
                f"{loss} against one rank's {ref['loss']}")
        require(max(grad_rel) <= tol_grad, f"dist-sp-train {arch}: first "
                f"moment {max(grad_rel)} of a leaf's max")
        require(counts["fused_matmul"] > 0 and all(
            counts[k] == 0 for k in ("flash_attention", "grouped_matmul",
                                     "rglru_scan", "rwkv6_scan")),
                f"dist-sp-train {arch}: launches {counts}")
        require(card.per_collective == meta["seq"].per_collective
                and scatter["seq"] > scatter["whole"],
                f"dist-sp-train {arch}: a step's collective bytes "
                f"{card.per_collective}, meta {meta}")
        launches[f"dist-sp-train-{arch}"] = counts
        del params, opt, ref_mu, metrics, card, meta
        torch.cuda.empty_cache()

    checks = _rec_kernel_checks(torch.Generator(device="cuda").manual_seed(
        DIST_SEED + r), DIST_SP_RANKS, DIST_SP_PROMPT)
    emit({"phase": "dist-sp-kernels", **head, "checks": checks})
    require(all(c["ok"] for c in checks), f"dist-sp-kernels: {checks}")
    (out_dir / f"sp_rank{r}.json").write_text(json.dumps(
        {"world": head, "launches": launches, "times": times}))


def phase_dist_sp(smi_line):
    """Every family under the reference's sequence parallelism on
    DIST_SP_RANKS ranks through ``launch.mesh.run_world`` (gloo: the
    ranks share the card; ``_dist_sp_rank``).  First, in this process,
    what the ranks are held to: each family's fp32 serving run off the
    mesh (its cache kept; OLMoE's GSPMD form routes the whole batch as it
    does) and each family's fp32 train step on one rank (its first
    moment saved for the ranks to read), under an abstract (data 2,
    model 2) mesh: OLMoE's shard_map form routes each data slice at the
    slice's capacity there, as the ranks and the reference do, and every
    other leaf runs whole.  A rank that fails, or a world that outlives
    DIST_SP_TIMEOUT, fails the phase."""
    import shutil

    from repro_torch.core import tree
    from repro_torch.distributed import logical
    from repro_torch.launch.mesh import abstract_mesh, run_world
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import make_train_step
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    one = {}
    for arch, n in DIST_SP_FP32_LAYERS.items():
        cfg = _cut(arch, n, dtype=torch.float32, kv_cache_dtype=torch.float32)
        mod = family_module(cfg)
        params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(
            DIST_SEED), "cuda")
        cache = mod.init_cache(cfg, MAX_BATCH, DIST_SP_CACHE.get(arch, 512),
                               device="cuda")
        got = _mesh_serve(cfg, params, cache, batch=_sp_batch(cfg))
        got["cache"] = tree.tree_map(lambda x: x.cpu(), got["cache"])
        got.pop("batch")
        one[f"serve-{arch}"] = got
        del params, cache, got
        torch.cuda.empty_cache()
    for arch in DIST_SP_TRAIN_LAYERS:
        cfg, tcfg = _sp_train_config(arch)
        params = family_module(cfg).init(cfg, torch.Generator(
            device="cuda").manual_seed(DIST_SEED), "cuda")
        with logical.use_rules(abstract_mesh((2, 2), ("data", "model"))):
            _, opt, metrics, _ = make_train_step(cfg, tcfg)(
                params, adamw.init(tcfg.optimizer, params),
                _sp_train_batch(cfg))
        mu = tree.tree_map(lambda x: x.cpu(), opt["mu"])
        one[f"train-{arch}"] = {"loss": float(metrics["loss"]), "mu_max": [
            float(x.abs().max()) for x in tree.leaves(mu)]}
        torch.save(mu, DIST_DIR / f"sp_train_mu_{arch}.pt")
        del params, opt, metrics, mu
        torch.cuda.empty_cache()
    torch.save(one, DIST_DIR / "sp_one.pt")
    one_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    try:
        run_world(_dist_sp_rank, DIST_SP_RANKS, (str(DIST_DIR),),
                  rendezvous=str(DIST_DIR / "rendezvous"),
                  timeout=DIST_SP_TIMEOUT)
    except Exception as e:                   # a rank failed or hung
        raise PhaseFailed(f"dist-sp: {type(e).__name__}: {e}") from None
    world_s = time.perf_counter() - t0
    ranks = [json.loads((DIST_DIR / f"sp_rank{i}.json").read_text())
             for i in range(DIST_SP_RANKS)]
    launches = {f"{path}/rank{i}": counts for i, got in enumerate(ranks)
                for path, counts in got["launches"].items()}
    emit({"phase": "dist-sp", "ranks": DIST_SP_RANKS,
          "backend": ranks[0]["world"]["backend"],
          "backend_reason": ranks[0]["world"]["backend_reason"],
          "nvidia_smi": smi_line, "times_rank0": ranks[0]["times"],
          "one_process_s": one_s, "world_wall_s": world_s,
          "wall_s": time.perf_counter() - t_phase, "launches": launches})
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Placements no experiment's rules give: a block whose leaves the rules
# place otherwise than its column/row form brought to it, a dim over
# model and data gathered whole, recurrent states that follow the heads
# and channels a rank computes.
# ---------------------------------------------------------------------------

def _forms_config(arch, layers, over, **kw):
    """A dist-forms run's configuration: ``arch`` at full width, cut to
    ``layers``, fp32, with ``over``."""
    return _cut(arch, layers, dtype=torch.float32,
                kv_cache_dtype=torch.float32, **over, **kw)


def _forms_key(arch, layers, over) -> str:
    """The one-process reference a dist-forms run shares with the runs of
    the same model."""
    return "-".join([arch, str(layers)] + [f"{k}={v}" for k, v in
                                           sorted(over.items())])


def _forms_decode_collectives(cfg, rules, sizes: dict, rows: int) -> dict:
    """Collective bytes by kind of one decode step of a dist-forms run:
    yi-6b, OLMoE-1B-7B (``shard_map`` form), RWKV-6-7B or
    RecurrentGemma-2B on one rank of a (data, model) mesh of ``sizes``
    under ``rules``, ``rows`` rows on the rank.
    ``tests/test_torch_placements.py`` holds it to the meta count.

    * A block runs in its column/row form where the rules split any of
      its projections over ``model`` (alone or with another axis) and
      ``model`` divides the dims that form splits; else whole, on every
      rank.  Its column/row form's exits all-reduce rows x d in fp32.
    * all-gather: each leaf over every axis that splits it but ``model``
      alone, one axis at a time, minor first, each result counted; then
      over ``model`` where the rules split it along another dim than its
      block's form takes (or the block runs whole).  The embedding (twice
      where tied: its lookup and the logits) and the output weight so;
      the logits over ``model`` (rows x vocab, fp32) where the output
      weight is split.
    * all-reduce: the vocab-parallel embedding's sum (rows x d).

    yi-6b and OLMoE: KV weights gathered over ``model`` where the rank's
    KV heads are not those its q heads read; the cache holds the rank's
    KV heads (no collective); OLMoE's experts block exits in the
    activation dtype.  RWKV-6: a whole time mix reads every head of a
    WKV state the rules share out over ``model`` (rows x H x 64 x 64,
    fp32); a split channel mix gathers its receptance (rows x d).
    Griffin: a split recurrent block gathers its conv output (rows x
    d_rnn) and writes its state back gathered over ``model``; a local
    attention whose ring is shared out over ``model`` gathers q and
    all-reduces the row max, then the sums and P·V (one KV head on every
    rank, from the gathered KV weights)."""
    from repro_torch.distributed import logical, sharding
    from repro_torch.launch.mesh import rank_view
    from repro_torch.models.base import family_module
    if set(sizes) != {"data", "model"}:
        raise ValueError("reckoned for (data, model) meshes")
    m = sizes["model"]
    e = torch.finfo(cfg.dtype).bits // 8
    d, v, n = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    q, kv, ff = cfg.q_dim, cfg.kv_dim, cfg.d_ff
    view = rank_view(tuple(sizes.values()), tuple(sizes))
    gather = reduce = 0

    def model_dim(spec):
        return next((i for i, x in enumerate(spec)
                     if sharding.axis_names(x) == ("model",)), None)

    def leaf(name, shape, want, eb=e):
        """A leaf's gathers: over its axes but model alone, then model
        where its block wants it along ``want`` (None: whole)."""
        spec = sharding.spec_of(name, shape)
        cur = list(sharding.local_shape(view, shape, spec))
        out = 0
        for i, entry in enumerate(spec):
            names = sharding.axis_names(entry)
            if names == ("model",):
                continue
            for a in reversed(names):
                if sizes[a] > 1:
                    cur[i] *= sizes[a]
                    out += math.prod(cur) * eb
        dim = model_dim(spec)
        if dim is not None and dim != want and m > 1:
            cur[dim] *= m
            out += math.prod(cur) * eb
        return out

    def block(leaves, divides=True):
        """(whether the block runs split, its leaves' gather bytes);
        ``leaves``: {name: (shape, the dim of its column/row form)}."""
        split = m > 1 and divides and any(
            "model" in sharding.axis_names(x) for name, (shape, _) in
            leaves.items() for x in sharding.spec_of(name, shape))
        return split, sum(leaf(k, shape, dim if split else None)
                          for k, (shape, dim) in leaves.items())

    def attention():
        """(the attention block's split, gather bytes), the cache the
        rank's KV heads, or one KV head a ring shares out."""
        shapes = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}
        split = m > 1 and q % m == 0 and any(
            "model" in sharding.axis_names(x) for k, shape in shapes.items()
            for x in sharding.spec_of(k, shape))
        dims = [model_dim(sharding.spec_of(k, (d, kv))) for k in ("wk",
                                                                 "wv")]
        want = dims[0] if dims[0] == dims[1] and dims[0] in (1, None) \
            else None
        out = (leaf("wq", shapes["wq"], 1 if split else None)
               + leaf("wo", shapes["wo"], 0 if split else None)
               + 2 * leaf("wk", shapes["wk"], want if split else None))
        group = cfg.n_heads // cfg.n_kv_heads
        own = cfg.n_kv_heads % m == 0 and (cfg.n_heads // m) % group == 0
        if split and want == 1 and not own:
            out += 2 * d * kv * e
        if split and cfg.n_heads % m:
            raise ValueError("reckoned for q heads that divide model")
        return split, out

    def mlp():
        split, out = block({"wi": ((d, 2 * ff), 1), "wo": ((ff, d), 0)},
                           ff % m == 0)
        return (rows * d * 4 if split else 0), out

    with logical.use_rules(view, rules):
        emb_split, b = block({"embedding": ((v, d), 0)}, v % m == 0)
        gather += b
        reduce += rows * d * e if emb_split else 0
        out_split, b = block({"embedding": ((v, d), 0)} if cfg.tie_embeddings
                             else {"lm_head": ((d, v), 1)}, v % m == 0)
        gather += b + (rows * v * 4 if out_split else 0)
        if cfg.family == "transformer":
            if cfg.n_kv_heads % m:
                raise ValueError("reckoned for a cache of the rank's KV "
                                 "heads")
            for _ in range(n):
                split, b = attention()
                gather += b
                reduce += rows * d * 4 if split else 0
                if cfg.moe is None:
                    r_, b = mlp()
                    gather, reduce = gather + b, reduce + r_
                    continue
                mo, mult = cfg.moe, 2 if cfg.mlp_glu else 1
                gather += leaf("w_router", (d, mo.n_experts), None, 4)
                split, b = block({
                    "experts_wi": ((mo.n_experts, d, mult * mo.d_ff_expert),
                                   0),
                    "experts_wo": ((mo.n_experts, mo.d_ff_expert, d), 0)},
                    mo.n_experts % m == 0)
                gather += b
                reduce += rows * d * e if split else 0
        elif cfg.family == "rwkv6":
            hs = cfg.rwkv.head_size
            h = d // hs
            cache = family_module(cfg).init_cache(cfg, rows * sizes["data"],
                                                  1, device="meta")
            wkv = sharding.cache_shardings(cache, view, cfg,
                                           rules)["wkv"].spec
            heads = tuple(a for a in sharding.axis_names(wkv[2])
                          if sizes[a] > 1)
            if sharding.axis_names(wkv[3]) or heads not in ((), ("model",)):
                raise ValueError("reckoned for a WKV state over model's "
                                 "heads or whole")
            for _ in range(n):
                split, b = block({**{k: ((d, d), 1) for k in (
                    "w_r", "w_k", "w_v", "w_g")}, "w_o": ((d, d), 0)},
                    d % m == 0)
                if split and h % m:
                    raise ValueError("reckoned for heads that divide model")
                gather += b
                reduce += rows * d * 4 if split else 0
                if not split and heads:          # every head read
                    gather += rows * h * hs * hs * 4
                if split and not heads:          # every head written
                    gather += rows * h * hs * hs * 4
                split, b = block({"w_cm_k": ((d, ff), 1),
                                  "w_cm_v": ((ff, d), 0),
                                  "w_cm_r": ((d, d), 1)},
                                 ff % m == 0 and d % m == 0)
                gather += b + (rows * d * e if split else 0)
                reduce += rows * d * 4 if split else 0
        elif cfg.family == "griffin":
            c, w = cfg.rnn.d_rnn, cfg.rnn.conv_width - 1
            pat = cfg.rnn.block_pattern
            if n % len(pat):
                raise ValueError("reckoned for whole (rec, rec, attn) "
                                 "triples")
            triples = n // len(pat)
            ring = m > 1 and cfg.window % m == 0
            for kind in pat * triples:
                if kind == "rec":
                    split, b = block({"w_gate_in": ((d, c), 1),
                                      "w_rnn_in": ((d, c), 1),
                                      "w_rnn_out": ((c, d), 0)},
                                     c % m == 0)
                    gather += b
                    if split:       # conv out; the state written back
                        gather += rows * c * e + rows * c * (w * e + 4)
                        reduce += rows * d * 4
                else:
                    split, b = attention()
                    gather += b + (rows * q * e if split and ring else 0)
                    reduce += rows * d * 4 if split else 0
                    h, hd = cfg.n_heads, cfg.head_dim
                    reduce += rows * h * 4 + rows * h * (1 + hd) * 4 \
                        if ring else 0
                r_, b = mlp()
                gather, reduce = gather + b, reduce + r_
        else:
            raise ValueError(f"no reckoning for the {cfg.family} family")
    out = {"all-gather": float(gather), "all-reduce": float(reduce)}
    out = {k: x for k, x in out.items() if x}
    out["total"] = sum(out.values())
    return out


def _dist_forms_rank(world, out_dir: str) -> None:
    """One rank of phase ``dist-forms``, spawned by ``run_world``: each run
    of DIST_FORMS on (data 2, model 2), the rank's 2 rows of the serve
    traffic's first batch held to the parent's one-process runs
    (``forms_one.pt``), a decode step's collective bytes counted on the
    card and on meta against ``_forms_decode_collectives``; then one
    AdamW step held to one process, which rank 0 takes on the whole model
    (under an abstract (2, 2) mesh for OLMoE's shard_map form), against
    each leaf of the first moment gathered from the ranks.  Each rank
    builds the whole model on the card in its turn and keeps its shards.
    Prints a dist-forms line a run, raises on a failed check (which fails
    the world) and writes its launch counts to ``out_dir/forms_rank{r}
    .json``."""
    import torch.distributed as dist
    from repro_torch.core import tree
    from repro_torch.core.precision import disable_tf32
    from repro_torch.distributed import collectives, logical, sharding
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh, make_mesh, rank_view
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import make_decode, make_prefill
    from repro_torch.training.train_step import TrainConfig, make_train_step
    global _EMIT_LOCK
    disable_tf32()
    out_dir, r = Path(out_dir), world.rank
    _EMIT_LOCK = out_dir / "emit.lock"
    one = torch.load(out_dir / "forms_one.pt")
    head = {"rank": r, "world": world.size, "backend": world.backend,
            "backend_reason": world.reason, "device": str(world.device)}
    mesh = make_mesh(DIST_FORMS_MESH, ("data", "model"))
    view = rank_view(DIST_FORMS_MESH, mesh.axis_names, mesh.coordinate)
    n = MAX_BATCH // DIST_FORMS_MESH[0]
    rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)
    s = int(max(prompt_lengths()[0][:MAX_BATCH]))
    wrappers = {**_moe_wrappers(), "rwkv6_scan": rwkv6_scan,
                "rglru_scan": rglru_scan}
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10),
        loss_chunk=DIST_TRAIN_FP32_BATCH[1])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.ones((8, 8), device="cuda") @ torch.ones((8, 8), device="cuda")
    torch.cuda.synchronize()
    workspace = torch.cuda.memory_allocated() - base
    launches, ref_train = {}, {}

    def seeded(cfg):
        return family_module(cfg).init(cfg, torch.Generator(
            device="cuda").manual_seed(DIST_SEED), "cuda")

    models = {}

    def built(cfg, key, rules):
        """The rank's shards of the seeded model under ``rules``, copies
        (the train step writes into them), from the whole model each
        rank builds once, in its turn, and keeps while its runs last."""
        if key not in models:
            models.clear()
            torch.cuda.empty_cache()
            for turn in range(world.size):
                if turn == r:
                    models[key] = seeded(cfg)
                dist.barrier()
        return tree.tree_map(lambda x: x.clone(), sharding.shard_params(
            models[key], mesh, rules, glu=cfg.mlp_glu))

    def events_ms(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    for run, (arch, layers, rules, over) in DIST_FORMS.items():
        cfg = _forms_config(arch, layers, over)
        key = _forms_key(arch, layers, over)
        mod = family_module(cfg)
        ref = one[key]
        params = built(cfg, key, rules)
        cache = sharding.shard_cache(mod.init_cache(
            cfg, MAX_BATCH, CACHE_LEN, device="cuda"), mesh, cfg, rules)
        read = _counted(wrappers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with logical.use_rules(mesh, rules):
            got = _mesh_serve(cfg, params, cache,
                              follow=ref["greedy"][:, :-1], rows=rows,
                              steps=DIST_FORMS_DECODE - 1)
            # the last decode step, counted on the card (and on meta)
            tok = ref["greedy"][rows, -2:-1].to("cuda", torch.int32)
            pos = s + DIST_FORMS_DECODE - 1
            card, (logits, _), _ = dryrun.count_step(make_decode(cfg), (
                params, tok, got["cache"], pos), False)
        torch.cuda.synchronize()
        serve_peak = torch.cuda.max_memory_allocated() - workspace
        counts = read()
        got["logits"].append(logits.float().cpu())
        mine = [x[rows] for x in ref["logits"]]
        errs = [rel_err(a, b)[0] for a, b in zip(got["logits"], mine)]
        greedy = torch.stack([x.argmax(-1) for x in got["logits"]], 1)
        agree = float((greedy == ref["greedy"][rows]).float().mean())
        with logical.use_rules(view, rules):
            mp = sharding.shard_params(mod.init(cfg, None, "meta"), view,
                                       rules, glu=cfg.mlp_glu)
            mc = sharding.shard_cache(mod.init_cache(
                cfg, MAX_BATCH, CACHE_LEN, device="meta"), view, cfg, rules)
            meta, _, _ = dryrun.count_step(make_decode(cfg), (
                mp, torch.empty((n, 1), dtype=torch.int32, device="meta"),
                mc, pos), False)
        reckoned = _forms_decode_collectives(cfg, rules, dict(mesh.shape), n)
        counted = {**{k: float(x) for k, x in card.per_collective.items()},
                   "total": card.collective_bytes}
        times = {"prefill_ms": got["prefill_ms"],
                 "decode_ms": got["decode_ms"]}
        del got, cache, mc
        torch.cuda.empty_cache()

        # one AdamW step (no remat: the FSDP gathers once a layer); rank 0
        # takes it on one process too
        train_cfg = cfg.with_(backend="torch", remat="none")
        if r == 0 and key not in ref_train:
            ref_train.clear()
            whole = tree.tree_map(lambda x: x.clone(), models[key])
            under = (logical.use_rules(abstract_mesh(DIST_FORMS_MESH, (
                "data", "model")), rules) if cfg.moe is not None
                and cfg.moe_shard_map else contextlib.nullcontext())
            with under:
                _, o, mt, _ = make_train_step(train_cfg, tcfg)(
                    whole, adamw.init(tcfg.optimizer, whole),
                    train_batch(train_cfg, *DIST_TRAIN_FP32_BATCH, "cuda"))
            # on the host: the card holds every rank's runs meanwhile
            ref_train[key] = (float(mt["loss"]),
                              [x.cpu() for x in tree.leaves(o["mu"])])
            del whole, o, mt
            torch.cuda.empty_cache()
        dist.barrier()
        opt = adamw.init(tcfg.optimizer, params)
        batch = sharding.local_batch(train_batch(
            train_cfg, *DIST_TRAIN_FP32_BATCH, "cuda"), mesh, 1, rules)
        read = _counted(wrappers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with logical.use_rules(mesh, rules):
            (tcard, (_, opt, metrics, _), _), train_ms = events_ms(
                lambda: dryrun.count_step(make_train_step(train_cfg, tcfg),
                                          (params, opt, batch), True))
        torch.cuda.synchronize()
        train_peak = torch.cuda.max_memory_allocated() - workspace
        tcounts = read()
        with logical.use_rules(view, rules):
            tmp = sharding.shard_params(family_module(train_cfg).init(
                train_cfg, None, "meta"), view, rules, glu=cfg.mlp_glu)
            tmeta, _, _ = dryrun.count_step(
                make_train_step(train_cfg, tcfg),
                (tmp, adamw.init(tcfg.optimizer, tmp),
                 {k: torch.empty(x.shape, dtype=x.dtype, device="meta")
                  for k, x in batch.items()}), True)
        del params, batch
        torch.cuda.empty_cache()
        worst = []

        def held(i, whole_mu):
            # in fp32: a float64 copy of an embedding's first moment (up
            # to 2.6 GB) does not fit beside the ranks' runs
            if r == 0:
                want = ref_train[key][1][i].cuda()
                worst.append(float((whole_mu - want).abs().max()
                                   / want.abs().max()))
            return None
        sharding.gather_params(opt["mu"], family_module(train_cfg).init(
            train_cfg, None, "meta"), mesh, rules, leaf_fn=held,
            glu=cfg.mlp_glu)
        grad = torch.tensor([max(worst) if worst else 0.0], device="cuda")
        collectives.broadcast(grad, 0)
        ref_loss = torch.tensor([ref_train[key][0] if r == 0 else 0.0],
                                device="cuda", dtype=torch.float64)
        collectives.broadcast(ref_loss, 0)
        loss, ref_loss = float(metrics["loss"]), float(ref_loss)
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        phase = f"dist-forms-{run}"
        emit({"phase": phase, **head, "serve": counts, "train": tcounts,
              "config": f"{arch} full width, {cfg.n_layers} layers, fp32, "
                        f"(data {DIST_FORMS_MESH[0]}, model "
                        f"{DIST_FORMS_MESH[1]}), rules {rules}, {over}; "
                        f"rows {rows.start}-{rows.stop - 1} of {MAX_BATCH}",
              "logits_rel_err": errs, "tol": TOL_FP32,
              "greedy_tokens_agree": agree,
              "collective_bytes_decode_step": counted,
              "collective_bytes_meta": meta.per_collective,
              "collective_bytes_reckoned": reckoned,
              **times, "one_process_prefill_ms": ref["prefill_ms"],
              "one_process_decode_ms": ref["decode_ms"],
              "loss": loss, "one_process_loss": ref_loss,
              "loss_rel": loss_rel, "tol_loss": TOL_TRAIN_LOSS,
              "mu_rel_max": float(grad), "tol_grad": TOL_TRAIN_GRAD,
              "train_step_ms": train_ms,
              "collective_bytes_train_step": tcard.per_collective,
              "collective_bytes_train_meta": tmeta.per_collective,
              "serve_max_memory_allocated": serve_peak,
              "train_max_memory_allocated": train_peak,
              "cublas_workspace": workspace})
        require(all(bool(torch.isfinite(x).all()) for x in mine),
                f"{phase}: one process's logits not finite")
        require(all(e_ <= TOL_FP32 for e_ in errs),
                f"{phase}: logits {errs} against {TOL_FP32}")
        require(agree == 1.0, f"{phase}: greedy tokens differ from one "
                "process's")
        require(counted == reckoned and card.per_collective
                == meta.per_collective, f"{phase}: a decode step's "
                f"collective bytes {counted}, meta {meta.per_collective}, "
                f"reckoned {reckoned}")
        require(loss_rel <= TOL_TRAIN_LOSS, f"{phase}: loss {loss} against "
                f"one process's {ref_loss}")
        require(float(grad) <= TOL_TRAIN_GRAD, f"{phase}: first moment "
                f"{float(grad)} of a leaf's max from one process's")
        require(tcard.per_collective == tmeta.per_collective,
                f"{phase}: a train step's collective bytes "
                f"{tcard.per_collective}, meta {tmeta.per_collective}")
        require(counts["fused_matmul"] > 0 and tcounts["fused_matmul"] > 0,
                f"{phase}: K1 launches {counts['fused_matmul']} serving, "
                f"{tcounts['fused_matmul']} training")
        if cfg.moe is not None:
            require(counts["grouped_matmul"] > 0, f"{phase}: no K4 launch")
        if cfg.family == "rwkv6":
            require(counts["rwkv6_scan"] == cfg.n_layers,
                    f"{phase}: K6 {counts['rwkv6_scan']} launches")
        launches[f"{phase}/serve"] = counts
        launches[f"{phase}/train"] = tcounts
        del opt, metrics, card, meta, tcard, tmeta, mp, tmp
        torch.cuda.empty_cache()
    (out_dir / f"forms_rank{r}.json").write_text(json.dumps(
        {"world": head, "launches": launches}))


def phase_dist_forms(smi_line):
    """Each run of DIST_FORMS on DIST_FORMS_RANKS ranks through
    ``launch.mesh.run_world`` (gloo: the ranks share the card;
    ``_dist_forms_rank``).  First, in this process, what the ranks'
    serving is held to: each model's fp32 serving run, off the mesh, or
    for OLMoE's shard_map form under an abstract (2, 2) mesh (each data
    slice routed at its capacity, the expert shards in turn), as the
    ranks route.  A rank that fails, or a world that outlives
    DIST_FORMS_TIMEOUT, fails the phase."""
    import shutil

    from repro_torch.distributed import logical
    from repro_torch.launch.mesh import abstract_mesh, run_world
    from repro_torch.models.base import family_module
    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    one = {}
    for arch, layers, rules, over in DIST_FORMS.values():
        key = _forms_key(arch, layers, over)
        if key in one:
            continue
        cfg = _forms_config(arch, layers, over)
        mod = family_module(cfg)
        params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(
            DIST_SEED), "cuda")
        cache = mod.init_cache(cfg, MAX_BATCH, CACHE_LEN, device="cuda")
        under = (logical.use_rules(abstract_mesh(DIST_FORMS_MESH, (
            "data", "model")), rules) if cfg.moe is not None
            and cfg.moe_shard_map else contextlib.nullcontext())
        with under:
            got = _mesh_serve(cfg, params, cache, steps=DIST_FORMS_DECODE)
        got.pop("cache")
        got.pop("batch")
        one[key] = got
        del params, cache
        torch.cuda.empty_cache()
    torch.save(one, DIST_DIR / "forms_one.pt")
    one_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    try:
        run_world(_dist_forms_rank, DIST_FORMS_RANKS, (str(DIST_DIR),),
                  rendezvous=str(DIST_DIR / "rendezvous"),
                  timeout=DIST_FORMS_TIMEOUT)
    except Exception as e:                   # a rank failed or hung
        raise PhaseFailed(f"dist-forms: {type(e).__name__}: {e}") from None
    world_s = time.perf_counter() - t0
    ranks = [json.loads((DIST_DIR / f"forms_rank{i}.json").read_text())
             for i in range(DIST_FORMS_RANKS)]
    launches = {f"{path}/rank{i}": counts for i, got in enumerate(ranks)
                for path, counts in got["launches"].items()}
    emit({"phase": "dist-forms", "ranks": DIST_FORMS_RANKS,
          "backend": ranks[0]["world"]["backend"],
          "backend_reason": ranks[0]["world"]["backend_reason"],
          "nvidia_smi": smi_line, "one_process_s": one_s,
          "world_wall_s": world_s,
          "wall_s": time.perf_counter() - t_phase, "launches": launches})
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Times at the paths' largest shapes.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# The dry run held to the card: the cost counter on meta and on the card.
# ---------------------------------------------------------------------------

def _dryrun_steps(cfg, device, gen=None):
    """The first batch of the serve traffic (4 prompts, padded to the
    longest, 221 tokens; a ``CACHE_LEN``-slot cache) as one prefill and
    one decode step of ``cfg`` on ``device``: ([(mode, fn, args)], the
    prefill's tokens), the weights seeded from ``gen`` (None on meta)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.base import family_module
    mod = family_module(cfg)
    lengths, rng = prompt_lengths()
    s = int(max(lengths[:MAX_BATCH]))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        MAX_BATCH, s))).to(device=device, dtype=torch.int32)
    params = mod.init(cfg, gen, device)
    cache = mod.init_cache(cfg, MAX_BATCH, CACHE_LEN, device=device)
    return [("prefill", dryrun.step_fn(cfg, "prefill"),
             (params, {"tokens": tokens}, cache)),
            ("decode", dryrun.step_fn(cfg, "decode"),
             (params, tokens[:, -1:], cache, s))], MAX_BATCH * s


def _dryrun_train(smi_line, wrappers, launches):
    """One train step of OLMoE-1B-7B at phase ``train``'s depth and batch
    (TRAIN_FAMILY_LAYERS, TRAIN_ARGV: 8 x 512 tokens in 2 microbatches),
    bf16, remat "full", on the plain torch route with K1 for the
    projections, as the launcher trains it: counted on meta
    (``training.train_step.abstract_state`` and a meta batch), then on
    the card (seeded weights, the stream's first batch).  Launches by
    kernel, FLOPs and bytes must be equal (a backward through the
    routing's top-k, sort-dispatch, capacity drop and combine), the
    card's counted launches those of the wrappers, the loss finite.  The
    meta trace's ``temp_bytes`` is reported beside the card's peak over
    what it held before the step, not held."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import parse_args
    from repro_torch.models.base import family_module
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import TrainConfig, abstract_state
    args = parse_args(TRAIN_ARGV)
    cfg = _cut(MOE_ARCH, TRAIN_FAMILY_LAYERS[MOE_ARCH], backend="torch")
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                    warmup_steps=max(args.steps // 20, 1)),
        microbatches=args.microbatches, loss_chunk=min(512, args.seq_len))
    fn = dryrun.step_fn(cfg, "train", tcfg)
    shape = (args.global_batch, args.seq_len)
    meta_batch = {k: torch.empty(shape, dtype=torch.int32, device="meta")
                  for k in ("tokens", "labels")}
    meta, _, meta_s = dryrun.count_step(
        fn, (*abstract_state(cfg, tcfg), meta_batch), True)
    params = family_module(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    args_card = (params, adamw.init(tcfg.optimizer, params),
                 train_batch(cfg, *shape, "cuda"))
    for w in wrappers.values():
        w.launches = 0
        w.launches_by_tile = dict.fromkeys(w.launches_by_tile, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    card, out, card_s = dryrun.count_step(fn, args_card, True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - live
    ran = {k: w.launches for k, w in wrappers.items() if w.launches}
    for k, w in wrappers.items():
        launches[k] += w.launches
        for t, n in w.launches_by_tile.items():
            launches[f"{k}_by_tile"][t] += n
    same, ops_differ = compare_counts(card, meta)
    finite = bool(torch.isfinite(out[2]["loss"]))
    emit({"phase": "dryrun", "arch": MOE_ARCH, "step": "train",
          "config": f"{MOE_ARCH} full width, {cfg.n_layers} of 16 layers, "
                    f"bf16, remat {cfg.remat}, batch {shape[0]} x "
                    f"{shape[1]} in {tcfg.microbatches} microbatches, "
                    "seeded random weights",
          "card": smi_line, "kernels_card": card.kernels,
          "kernels_meta": meta.kernels, "flops": [card.flops, meta.flops],
          "bytes": [card.bytes, meta.bytes], "launches": ran,
          "ops_differ": ops_differ, "temp_bytes_meta": meta.temp_bytes,
          "card_peak_over_live": peak,
          "trace_s": {"meta": meta_s, "card": card_s},
          "loss_finite": finite, "same": same})
    require(same, f"dryrun {MOE_ARCH} train: the card counted "
            f"{card.kernels} ({card.flops} FLOPs, {card.bytes} B), meta "
            f"{meta.kernels} ({meta.flops}, {meta.bytes})")
    require({k: v["calls"] for k, v in card.kernels.items()
             if k in wrappers} == ran,
            f"dryrun {MOE_ARCH} train: counted {card.kernels}, launched "
            f"{ran}")
    require(finite, f"dryrun {MOE_ARCH} train: non-finite loss")
    del params, args_card, out
    torch.cuda.empty_cache()


def phase_dryrun(smi_line):
    """The one-card dry run (``launch/dryrun.py``) held to the card: yi-6b
    (32 layers) and OLMoE-1B-7B (16 layers, 64 experts) at full size,
    bf16, on the serve traffic's first batch: one prefill and one decode
    step, each counted first on meta, then on the card
    (``core.hlo_cost``).  Launches by kernel, FLOPs and bytes must be
    equal, and the card's counted launches those of the wrappers.  Then
    each step's roofline (H100 data-sheet peaks) beside the median
    CUDA-event time of 5 uncounted runs on the card, and the meta trace's
    ``temp_bytes`` beside the card's peak allocation over its arguments
    and over all it held before the step (reported, not held).  Last, the Hopper Eq. 2 tile beside K1's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import constraint
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.precision import DataType
    from repro_torch.core.roofline import Roofline
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    from repro_torch.launch import dryrun

    wrappers = {"fused_matmul": fused_matmul,
                "flash_attention": flash_attention,
                "grouped_matmul": grouped_matmul}
    launches = dict.fromkeys(wrappers, 0)
    for name, w in wrappers.items():
        launches[f"{name}_by_tile"] = dict.fromkeys(w.launches_by_tile, 0)
    steps_out = []
    for arch in (ARCH, MOE_ARCH):
        cfg = get_config(arch)
        meta_steps, n_tokens = _dryrun_steps(cfg, "meta")
        metas = [dryrun.count_step(fn, args, False)
                 for _, fn, args in meta_steps]
        gen = torch.Generator(device="cuda").manual_seed(0)
        card_steps, _ = _dryrun_steps(cfg, "cuda", gen)
        n_active = cfg.param_count(active_only=cfg.moe is not None)
        for (mode, fn, args), (meta, _, meta_s) in zip(card_steps, metas):
            arg_bytes = dryrun.tree_bytes(args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            for w in wrappers.values():
                w.launches = 0
                w.launches_by_tile = dict.fromkeys(w.launches_by_tile, 0)
            card, out, card_s = dryrun.count_step(fn, args, False)
            torch.cuda.synchronize()
            ran = {k: w.launches for k, w in wrappers.items() if w.launches}
            peak = torch.cuda.max_memory_allocated()
            for k, w in wrappers.items():
                launches[k] += w.launches
                for t, n in w.launches_by_tile.items():
                    launches[f"{k}_by_tile"][t] += n
            finite = bool(torch.isfinite(out[0]).all())
            ms = _events_ms(lambda: fn(*args))
            tokens = n_tokens if mode == "prefill" else MAX_BATCH
            roof = Roofline(card.flops, card.bytes, card.collective_bytes, 1,
                            2.0 * n_active * tokens)
            same, ops_differ = compare_counts(card, meta)
            line = {
                "phase": "dryrun", "arch": arch, "step": mode,
                "config": f"{arch} full width and depth ({cfg.n_layers} "
                          f"layers), bf16, seeded random weights",
                "card": smi_line,
                "kernels_card": card.kernels, "kernels_meta": meta.kernels,
                "flops": [card.flops, meta.flops],
                "bytes": [card.bytes, meta.bytes],
                "launches": ran, "ops_differ": ops_differ,
                "roofline": {k: roof.as_dict()[k] for k in (
                    "compute_s", "memory_s", "dominant",
                    "useful_flops_ratio")},
                "bound_ms": roof.bound_s * 1e3, "event_ms": ms,
                "share_of_bound": roof.bound_s * 1e3 / ms,
                "temp_bytes_meta": meta.temp_bytes,
                "card_peak_over_args": peak - arg_bytes,
                "card_peak_over_live": peak - live,
                "trace_s": {"meta": meta_s, "card": card_s},
                "logits_finite": finite, "same": same}
            emit(line)
            steps_out.append(line)
            require(same, f"dryrun {arch} {mode}: the card counted "
                    f"{card.kernels} ({card.flops} FLOPs, {card.bytes} B), "
                    f"meta {meta.kernels} ({meta.flops}, {meta.bytes})")
            require({k: v["calls"] for k, v in card.kernels.items()} == ran,
                    f"dryrun {arch} {mode}: counted {card.kernels}, "
                    f"launched {ran}")
            require(finite, f"dryrun {arch} {mode}: non-finite logits")
        del card_steps, args, out
        torch.cuda.empty_cache()
    _dryrun_train(smi_line, wrappers, launches)
    require(all(launches[k] for k in wrappers),
            f"dryrun: a kernel of the path never launched: {launches}")
    tiles = {}
    for tag, dt, step in (("bf16", DataType.BF16, constraint.WGMMA_M),
                          ("bf16_step128", DataType.BF16, 128),
                          ("int8", DataType.INT8, constraint.WGMMA_M)):
        t = constraint.solve_tiles(dt, step=step)
        tiles[tag] = {"bm": t.bm, "bn": t.bn, "bk": t.bk,
                      "smem_bytes": t.smem_bytes,
                      "compute_bound": t.compute_bound,
                      "ideal_utilization": t.ideal_utilization}
    emit({"phase": "dryrun-eq2", "solve_tiles": tiles,
          "k1_tc_tile": {"bm": mm.TC_BM, "bn": mm.TC_BN, "bk": mm.TC_BK,
                         "stages": mm.TC_STAGES},
          "ridge_flop_per_byte": constraint.arithmetic_intensity_needed(),
          "l2_bytes_reported": torch.cuda.get_device_properties(0)
          .L2_cache_size,
          "l2_bytes_table": H100_SXM.l2_bytes,
          "sms_reported": torch.cuda.get_device_properties(0)
          .multi_processor_count})
    return launches


# ---------------------------------------------------------------------------
# Phase examples: the port-side examples on the card.
# ---------------------------------------------------------------------------

def example_module(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod         # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _dryrun_cells(out_dir: Path):
    """yi-6b's one-card dry-run cells (``EXAMPLES_DRYRUN_SHAPES``), one
    subprocess a cell on the host (meta tensors; the card hidden)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", shape, "--mesh", "h100", "--out", str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for shape in EXAMPLES_DRYRUN_SHAPES}


def phase_examples(smi_line):
    """The six port-side examples (``examples/<name>_torch.py``) through
    their ``main`` on the card at the reference scripts' sizes, and the
    roofline report (``launch/roofline.py``) over yi-6b's one-card
    dry-run cells, written by ``launch/dryrun.py`` in subprocesses on the
    host beside the first five examples and read before train_lm, which
    runs alone.  Each kernel's output is held against its plain version
    on the same operands: sim_timeline's graph (one K1 launch a matrix
    tile, int8) equals ``cute_matmul`` on the torch route bit for bit
    and the fused kernel within TOL_EXAMPLES_FP32; cluster_scaling's
    ``kernel`` and ``sharded`` outputs equal the exact int32 product bit
    for bit for all three strategies; quickstart's engine and kernel
    route lie within TOL_EXAMPLES_BF16 of ``cute_matmul`` on the torch
    route and of each other, its pipelined fp32 product within TOL_FP32
    of the plain fp32 product and GELU; serve_batched's greedy tokens on
    the kernel route equal the torch route's for each model (fp32);
    train_lm at its default width resumes from its step-100 checkpoint
    and ends below its first loss, its first EXAMPLES_TRAIN_ROUTE_STEPS
    losses within TOL_TRAIN_LOSS of the same seeded run's on the torch
    route.  The simulated figures are host Python, held ``==`` to the
    reference's by the CPU tests (``tests/test_torch_examples.py``).  K1,
    K2, K5 and K6 launches by tile, each example's counted alone (the
    plain versions' runs uncounted)."""
    import io
    import os
    import shutil
    import tempfile
    from repro_torch import backend
    from repro_torch.core import ACTIVATIONS, EpilogueOperands
    from repro_torch.core.fusion import cute_matmul
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.matmul import tile_for
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    from repro_torch.launch import roofline

    wrappers = {"fused_matmul": fused_matmul,
                "flash_attention": flash_attention,
                "rglru_scan": rglru_scan, "rwkv6_scan": rwkv6_scan}
    launches = dict.fromkeys(wrappers, 0)
    for name, w in wrappers.items():
        if hasattr(w, "launches_by_tile"):
            launches[f"{name}_by_tile"] = dict.fromkeys(w.launches_by_tile, 0)
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="examples_", dir=ROOT / "build"))
    t_phase = time.perf_counter()
    cells = _dryrun_cells(out_dir / "dryrun")
    seconds = {}

    def run(name, argv, tag=None, cwd=None):
        """``main(argv)`` of the example ``name``, counted: (module, what
        it returned, its printed lines, its launches)."""
        mod = example_module(f"{name}_torch")
        read = _counted(wrappers)
        buf, here = io.StringIO(), os.getcwd()
        t0 = time.perf_counter()
        try:
            if cwd is not None:
                os.chdir(cwd)
            with contextlib.redirect_stdout(buf):
                got = mod.main(argv)
            torch.cuda.synchronize()
        finally:
            os.chdir(here)
        seconds[tag or name] = time.perf_counter() - t0
        ran = read()
        for k in wrappers:
            launches[k] += ran[k]
            for t_, n in ran.get(f"{k}_by_tile", {}).items():
                launches[f"{k}_by_tile"][t_] += n
        return mod, got, buf.getvalue().splitlines(), ran

    def launched(ran):
        """The kernels of ``ran`` (a ``_counted`` reading) that launched."""
        return {k: v for k, v in ran.items()
                if (any(v.values()) if isinstance(v, dict) else v)}

    def line(name, lines, ran, **kw):
        emit({"phase": "examples", "example": name, "card": smi_line,
              "seconds": seconds[name], "launches": launched(ran),
              "stdout": lines, **kw})

    def exact_int(a, b):
        """``a @ b`` of int8 operands into int32, exactly (an fp64
        product: every sum of int8 products here lies far inside 2^53)."""
        return (a.double() @ b.double()).to(torch.int32)

    try:
        # sim_timeline: one K1 launch a matrix tile of the PANEL graph,
        # and the one fused cute_matmul it is held against
        mod, got, lines, ran = run("sim_timeline", [
            "--out", str(out_dir / "desim_trace.json")])
        plain = cute_matmul(got["a"], got["b"], epilogue=mod.EPILOGUE,
                            backend="torch")
        exact = bool(torch.equal(got["out"], plain))
        fused_rel, _ = rel_err(got["out"], got["ref"])
        expect = _reckon_tiles(got["graph"])
        expect[tile_for(got["a"], got["b"], mod.EPILOGUE)] += 1
        line("sim_timeline", lines, ran, graph_equals_torch_route=exact,
             fused_rel_err=fused_rel, k1_reckoned=expect)
        require(exact, "examples sim_timeline: the kernel backend's graph "
                "differs from cute_matmul on the torch route")
        require(fused_rel <= TOL_EXAMPLES_FP32,
                f"examples sim_timeline: {fused_rel} from the fused kernel")
        require(ran["fused_matmul_by_tile"] == expect,
                f"examples sim_timeline: K1 {ran}, reckoned {expect}")

        mod, got, lines, ran = run("cluster_scaling", [
            "--units", str(EXAMPLES_UNITS), "--out",
            str(out_dir / "cluster_trace.json")])
        want = exact_int(got["a"], got["b"])
        plain_equal = {"kernel": bool(torch.equal(got["kernel"], want))}
        plain_equal.update({s: bool(torch.equal(out, want))
                            for s, (_, out) in got["strategies"].items()})
        line("cluster_scaling", lines, ran, sharded_equals_kernel=got["exact"],
             equals_exact_product=plain_equal)
        require(list(got["exact"]) == list(mod.STRATEGIES)
                and all(got["exact"].values()),
                f"examples cluster_scaling: sharded != kernel {got['exact']}")
        require(all(plain_equal.values()), f"examples cluster_scaling: "
                f"outputs differ from the exact product {plain_equal}")

        mod, got, lines, ran = run("serving_policies", [], cwd=out_dir)
        line("serving_policies", lines, ran)
        require(not launched(ran),
                f"examples serving_policies launched {launched(ran)}")

        mod, got, lines, ran = run("quickstart", [])
        plain = cute_matmul(got["a"], got["w"], epilogue=mod.EPILOGUE,
                            operands=EpilogueOperands(bias=got["bias"]),
                            backend="torch").float()
        q_rel = {"engine": rel_err(got["out"].float(), plain)[0],
                 "kernel_route": rel_err(got["kernel"].float(), plain)[0],
                 "engine_to_kernel_route": rel_err(
                     got["kernel"].float(), got["out"].float())[0]}
        pipe_plain = ACTIVATIONS["gelu"](cute_matmul(
            got["a"].float(), got["w"].float(), backend="torch"))
        pipe_rel, _ = rel_err(got["pipelined"], pipe_plain)
        line("quickstart", lines, ran, rel_err_bf16=q_rel,
             pipelined_rel_err=pipe_rel, dispatch_done=got["done"])
        require(max(q_rel.values()) <= TOL_EXAMPLES_BF16,
                f"examples quickstart: {q_rel} from the torch route")
        require(pipe_rel <= TOL_FP32, f"examples quickstart: the pipelined "
                f"product {pipe_rel} from the plain fp32 product")
        # the engine's call, the pipelined product's 4 row tiles, the
        # kernel route's call
        require(ran["fused_matmul"] == 6,
                f"examples quickstart: K1 launched {launched(ran)}")

        mod, got, lines, ran = run("serve_batched", [])
        same = {}
        for arch in mod.ARCHS:
            cfg = mod.config(arch)
            torch_route = mod.serve(arch, mod.init_params(cfg, "cuda"),
                                    mod.prompts(cfg, "cuda"), route="torch",
                                    verbose=False)
            same[arch] = all(torch.equal(a, b) for a, b in
                             zip(got[arch], torch_route))
        line("serve_batched", lines, ran, greedy_equal_torch_route=same)
        require(all(same.values()), f"examples serve_batched: greedy tokens "
                f"of the kernel route differ from the torch route's {same}")
        for k in wrappers:
            require(ran[k], f"examples serve_batched: {k} never "
                    f"launched ({launched(ran)})")

        # the roofline report over the dry run's records of yi-6b, once
        # the cells' subprocesses are done, so that train_lm runs alone
        t0 = time.perf_counter()
        dry = {}
        for shape, p in cells.items():
            out, _ = p.communicate(timeout=600)
            dry[shape] = {"rc": p.returncode,
                          "last_line": out.strip().splitlines()[-1:]}
            path = out_dir / "dryrun" / "h100" / f"{ARCH}__{shape}.json"
            if path.exists():
                rec = json.loads(path.read_text())
                dry[shape].update(build_s=rec.get("build_s"),
                                  trace_s=rec.get("trace_s"))
        seconds["dryrun_wait"] = time.perf_counter() - t0
        seconds["dryrun_done_at"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows, picks = roofline.main(["--results", str(out_dir / "dryrun")])
        seconds["roofline"] = time.perf_counter() - t0
        report = buf.getvalue().splitlines()
        emit({"phase": "examples", "example": "roofline", "card": smi_line,
              "seconds": seconds["roofline"], "dryrun": dry,
              "dryrun_wait_s": seconds["dryrun_wait"], "stdout": report,
              "picks": {k: f"{v['arch']} x {v['shape']}"
                        for k, v in (picks or {}).items()},
              "hbm_ok": {r["shape"]: r["hbm_ok"] for r in rows}})
        require(all(d["rc"] == 0 for d in dry.values()),
                f"examples roofline: a dry-run cell failed {dry}")
        require(sorted(r["shape"] for r in rows)
                == sorted(EXAMPLES_DRYRUN_SHAPES)
                and all(r["mesh"] == "h100" for r in rows) and picks,
                f"examples roofline: rows {rows}, picks {picks}")

        ckpt = out_dir / "train_lm"
        first_steps, last_steps = EXAMPLES_TRAIN_STEPS
        mod, first, lines1, ran1 = run("train_lm", [
            "--steps", str(first_steps), "--ckpt-dir", str(ckpt)],
            tag="train_lm_first")
        mod, again, lines2, ran2 = run("train_lm", [
            "--steps", str(last_steps), "--ckpt-dir", str(ckpt)],
            tag="train_lm_resume")
        seconds["train_lm"] = (seconds["train_lm_first"]
                               + seconds["train_lm_resume"])
        # the first run's opening steps again, from the same seeded
        # params and stream, with every projection on the torch route
        args = mod.arguments([])
        read = _counted(wrappers)
        prev = backend.set_default_matmul_backend("torch")
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                plain = mod.train(
                    mod.build_config(args.small), steps=first_steps,
                    until=EXAMPLES_TRAIN_ROUTE_STEPS,
                    global_batch=args.global_batch, seq_len=args.seq_len,
                    ckpt_dir=str(out_dir / "train_lm_torch"), device="cuda")
        finally:
            backend.set_default_matmul_backend(prev)
        plain_launches = launched(read())
        route_rel = [abs(k - t) / abs(t) for k, t in
                     zip(first.losses, plain.losses)]
        losses = first.losses + again.losses
        ms = statistics.median(first.step_ms[1:] + again.step_ms[1:])
        resumed = "resumed from step 100" in lines2
        # step 100's loss is taken before its update: the resumed run's
        # equals the first run's only if the checkpoint restored every
        # leaf and the stream's position
        same_step = again.losses[:1] == first.losses[100:101]
        both = {k: ({t: v[t] + ran2[k][t] for t in v}
                    if isinstance(v, dict) else v + ran2[k])
                for k, v in ran1.items()}
        line("train_lm", lines1 + lines2, both,
             launches_first=launched(ran1), launches_resume=launched(ran2),
             start=[first.start, again.start], checkpoints=again.steps,
             first_loss=losses[0], final_loss=losses[-1],
             step_100_loss=[first.losses[100], again.losses[0]],
             torch_route_losses=plain.losses, torch_route_rel=route_rel,
             tol_loss=TOL_TRAIN_LOSS, torch_route_launches=plain_launches,
             median_step_ms=ms, step_ms_first=first.step_ms[0])
        require(first.start == 0 and len(first.losses) == first_steps
                and first.steps == [100], f"examples train_lm: the first "
                f"run took {len(first.losses)} steps, checkpoints "
                f"{first.steps}")
        require(resumed and again.start == 100
                and len(again.losses) == last_steps - 100,
                f"examples train_lm: no resume from step 100 ({lines2})")
        require(same_step, f"examples train_lm: step 100's loss "
                f"{again.losses[:1]} after the resume, "
                f"{first.losses[100:101]} before")
        require(all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0],
                f"examples train_lm: final loss {losses[-1]}, first "
                f"{losses[0]}")
        require(len(route_rel) == EXAMPLES_TRAIN_ROUTE_STEPS
                and max(route_rel) <= TOL_TRAIN_LOSS and not plain_launches,
                f"examples train_lm: the kernel route's losses "
                f"{first.losses[:EXAMPLES_TRAIN_ROUTE_STEPS]}, the torch "
                f"route's {plain.losses} (launched {plain_launches})")
        del first, again, plain
    finally:
        for p in cells.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    emit({"phase": "examples", "card": smi_line, "wall_s": wall,
          "seconds": seconds, "launches": launches})
    for k in wrappers:
        require(launches[k], f"examples: {k} never launched ({launches})")
    return launches


def time_ms(fns: dict, reps: int = 10, warmup: int = 2,
            flush=None) -> dict:
    """Median CUDA-event time of each callable, called in turns
    (a, b, c, c, b, a, ...).  ``flush``, if given, runs before each timed
    call, outside the timed window."""
    for f in fns.values():
        for _ in range(warmup):
            f()
    torch.cuda.synchronize()
    names = list(fns)
    samples = {n: [] for n in names}
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            if flush is not None:
                flush()
            start.record()
            fns[n]()
            end.record()
            end.synchronize()
            samples[n].append(start.elapsed_time(end))
    return {n: statistics.median(v) for n, v in samples.items()}


def graph_ms(fns: dict, calls: int = 10) -> dict:
    """``time_ms`` per call of ``calls`` calls of each callable captured in
    one CUDA graph: a replay launches them back to back, so the host's
    time a call (the wrapper's checks and allocations) is out of the
    timing and what remains is the device's."""
    replays = {}
    for name, f in fns.items():
        f()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                f()
        replays[name] = g.replay
    return {n: ms / calls for n, ms in time_ms(replays).items()}


def rotating(fn, copies):
    """A callable that calls ``fn`` on the next of ``copies`` (argument
    tuples) in turn and keeps what each call returns.  Under ``graph_ms``
    each captured call then reads inputs and writes outputs that the
    calls just before it did not touch: with copies that together exceed
    the 50 MB L2, every call's reads come from device memory, as a
    served call's do."""
    calls, kept = [0], []

    def call():
        kept.append(fn(*copies[calls[0] % len(copies)]))
        calls[0] += 1
    return call


def _scaled_mm(a, b):
    """(a callable of ``torch._scaled_mm`` on fp8 ``a`` and ``b``, B
    column-major, one fp32 scale each, fp32 out; what it is) where the
    library takes the operands, else (None, why not): a yardstick only."""
    bt = b.t().contiguous().t()
    one = torch.ones((), device="cuda")

    def call():
        return torch._scaled_mm(a, bt, scale_a=one, scale_b=one,
                                out_dtype=torch.float32)
    try:
        call()
    except (RuntimeError, ValueError) as e:   # shapes or types it refuses
        return None, f"none: torch._scaled_mm refused ({str(e)[:160]})"
    return call, ("torch._scaled_mm, B column-major, tensor-wide scales, "
                  "fp32 out (no epilogue)")


def _int_mm(a, b):
    """(a callable of ``torch._int_mm`` on int8 ``a`` and ``b``, int32 out;
    what it is) where the library takes the operands (B column-major,
    cuBLASLt's layout, else as it is), else (None, why not): a yardstick
    only."""
    why = ""
    for layout, bt in (("column-major", b.t().contiguous().t()),
                       ("row-major", b)):
        def call(bt=bt):
            return torch._int_mm(a, bt)
        try:
            call()
        except (RuntimeError, ValueError) as e:   # layouts it refuses
            why = str(e)[:160]
            continue
        return call, f"torch._int_mm, B {layout}, int32 out (no epilogue)"
    return None, f"none: torch._int_mm refused ({why})"


def bound(flops: float, nbytes: float, peak: float, bw: float):
    t_ops, t_bytes = flops / peak, nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_timing(cfg, moe_cfg, g_cfg, r_cfg, s_max, path_launches):
    """``path_launches``: path -> {kernel name: launches in that path}."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.core.hardware import H100_SXM as chip
    from repro_torch.kernels.attention.attention import (
        flash_attention_simt, tile_for as attention_tile_for)
    from repro_torch.kernels.matmul.matmul import tile_for
    from repro_torch.kernels.moe.grouped_matmul import (
        tile_for as grouped_tile_for)
    from repro_torch.kernels.rwkv6.rwkv6 import (
        rwkv6_wkv_simt, tile_for as wkv_tile_for)
    from repro_torch.models.moe import moe_capacity
    gen = torch.Generator(device="cuda").manual_seed(4)
    kernels = []

    def counts(name):
        by_path = {path: n[name] for path, n in path_launches.items()
                   if name in n}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    def by_tile(name):
        out = {}
        for p_ in path_launches.values():
            for t_, n in p_.get(f"{name}_by_tile", {}).items():
                out[t_] = out.get(t_, 0) + n
        return out

    def k2_row(h, hkv, hd, window, tag, sq=s_max, sk=s_max, causal=True,
               transposed=False):
        """K2 at a path's shape, bf16 (4, h, sq, hd) against (4, hkv, sk,
        hd), on the tile the rule names, beside its SIMT tile at the same
        shape, the plain version and SDPA; each timed as 10 calls
        replayed from a CUDA graph (``graph_ms``), as K1: a call's host
        time (two tensor maps to encode) is of the order of its device
        time.  A causal row has sq == sk."""
        q, kk, v = attention_case(gen, MAX_BATCH, h, hkv, sq, sk, hd,
                                  torch.bfloat16, transposed=transposed)
        k_rep, v_rep = (x.repeat_interleave(h // hkv, dim=1) for x in (kk, v))
        kw = dict(sm_scale=hd ** -0.5, causal=causal, window=window,
                  softcap=0.0, q_start=0)
        t = graph_ms({
            "kernel": lambda: run_attention(q, kk, v, **kw),
            "simt": lambda: flash_attention_simt(q, kk, v, **kw),
            "plain": lambda: plain_attention(q, kk, v, **kw),
            "library": lambda: F.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=causal, scale=hd ** -0.5)})
        ref = plain_attention(q, kk, v, **kw)
        _, diff = rel_err(run_attention(q, kk, v, **kw), ref)
        _, diff_simt = rel_err(flash_attention_simt(q, kk, v, **kw), ref)
        tile = attention_tile_for(q, kk, v)
        pairs = sq * (sq + 1) // 2 if causal else sq * sk   # (q, k) pairs
        ms, by = bound(4.0 * MAX_BATCH * h * pairs * hd,
                       2.0 * (2 * q.numel() + kk.numel() + v.numel()),
                       chip.peak_bf16, chip.hbm_bw)
        kernels.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "flash_attention_sm90.cu" if tile == "tc" else
                "flash_attention.cu"),
            "replaces": "src/repro/kernels/attention/attention.py:34",
            **counts("flash_attention"),
            "launches_by_tile": by_tile("flash_attention"),
            "tile": tile, "max_abs_err": diff,
            "ms": t["kernel"], "simt_ms": t["simt"],
            "simt_max_abs_err": diff_simt, "plain_ms": t["plain"],
            "bound_ms": ms, "bound_by": by, "library_ms": t["library"],
            "timing": "per call, median of 10 replays (in turns) of a CUDA "
                      "graph of 10 calls",
            "shape": f"bf16 q ({MAX_BATCH},{h},{sq},{hd}) kv "
                     f"({MAX_BATCH},{hkv},{sk},{hd}) "
                     f"{'causal' if causal else 'non-causal'}{tag}",
            "library_call": "F.scaled_dot_product_attention on KV heads "
                            "repeated to H beforehand"})

    # K1 at its largest path shapes: the prefill GLU MLP input projection
    # (tensor-core tile), the same weight at the decode rows and the
    # logits at the decode rows (decode tile).  Each is timed as 10 calls
    # replayed from a CUDA graph (``graph_ms``): at decode the wrapper's
    # host time is of the order of the kernel's.  The weights (180 and
    # 524 MB) exceed the 50 MB L2, so no call finds B cached.
    k, n = cfg.d_model, 2 * cfg.d_ff
    for tag, rows, n_b, glu, out_dt in (
            ("prefill", MAX_BATCH * s_max, n, True, None),
            ("decode", MAX_BATCH, n, True, None),
            ("logits", MAX_BATCH, cfg.padded_vocab, False, torch.float32)):
        a, b, ep, ops = matmul_case(gen, rows, k, n_b, torch.bfloat16,
                                    glu=glu, act="silu" if glu else "none",
                                    out_dtype=out_dt)

        t = graph_ms({"kernel": lambda: run_matmul(a, b, ep, ops),
                      "plain": lambda: plain_matmul(a, b, ep, ops),
                      "library": lambda: torch.matmul(a, b)})
        tile = tile_for(a, b, ep)
        _, diff = rel_err(run_matmul(a, b, ep, ops),
                          plain_matmul(a, b, ep, ops))
        n_out = n_b // 2 if glu else n_b
        out_bytes = (4 if out_dt == torch.float32 else 2) * rows * n_out
        ms, by = bound(2.0 * rows * n_b * k,
                       2.0 * (rows * k + k * n_b) + out_bytes,
                       chip.peak_bf16, chip.hbm_bw)
        kernels.append({
            "name": "fused_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "fused_matmul_sm90.cu" if tile == "tc" else
                "decode_tile.cuh" if tile == "decode" else "gemm_tile.cuh"),
            "replaces": "src/repro/kernels/matmul/matmul.py:39",
            **counts("fused_matmul"),
            "launches_by_tile": by_tile("fused_matmul"),
            "tile": tile, "max_abs_err": diff,
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
            "bound_by": by, "library_ms": t["library"],
            "shape": f"{tag}: bf16 ({rows},{k})@({k},{n_b})"
                     f"{' GLU-silu' if glu else ''} -> ({rows},{n_out})"
                     f"{' fp32' if out_dt == torch.float32 else ''}",
            "library_call": "torch.matmul (no epilogue)"})

    # K1's backward at the training GLU projection (2,048 rows, bf16): the
    # accumulator recomputed through K1 (tensor-core tile, fp32 out), the
    # epilogue's vector-Jacobian product in plain ops, dA and dB as fp32
    # ``torch.matmul`` (TF32 off); beside autograd of the plain version.
    # Each timed as one backward between CUDA events (autograd does not
    # capture into a CUDA graph here).  The function's inputs are bf16, so
    # ``bound_ms`` counts the recompute and dA, dB at the bf16 peak;
    # ``bound_fp32_ms`` counts dA and dB at the fp32 peak, as the Function
    # forms them (fp32 operands, TF32 off, as the reference's autodiff of
    # its fp32-accumulating matmul does); both against the bytes of a, b
    # and g read and of dA and dB written, in bf16.
    from repro_torch.core.fusion import EpilogueOperands
    from repro_torch.kernels.matmul.ref import fused_matmul_ref
    m, n_b = TRAIN_ROWS, 2 * cfg.d_ff
    a, b, g, ep = matmul_backward_case(gen, m, k, n_b, torch.bfloat16,
                                       "silu")
    out = run_matmul(a, b, ep, EpilogueOperands())
    ref_out = fused_matmul_ref(a, b, epilogue=ep)
    t = time_ms({
        "kernel": lambda: torch.autograd.grad(out, (a, b), g,
                                              retain_graph=True),
        "plain": lambda: torch.autograd.grad(ref_out, (a, b), g,
                                             retain_graph=True)})
    errs = [rel_err(x, r)[1] for x, r in zip(
        torch.autograd.grad(out, (a, b), g, retain_graph=True),
        plain_matmul_backward(a, b, g, ep))]
    flop = 2.0 * m * n_b * k
    t_ops = 3 * flop / chip.peak_bf16
    t_ops32 = flop / chip.peak_bf16 + 2 * flop / chip.peak_fp32
    t_bytes = 2.0 * (2 * m * k + 2 * k * n_b + m * n_b // 2) / chip.hbm_bw
    kernels.append({
        "name": "fused_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/matmul/ops.py (the op "
                  "repro_torch::fused_matmul and its _backward; "
                  "its K1 launch src/repro_torch/kernels/csrc/"
                  "fused_matmul_sm90.cu)",
        "replaces": "src/repro/kernels/matmul/matmul.py:39",
        **counts("fused_matmul"),
        "launches_by_tile": by_tile("fused_matmul"),
        "tile": "tc", "max_abs_err": max(errs),
        "ms": t["kernel"], "plain_ms": t["plain"],
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_fp32_ms": max(t_ops32, t_bytes) * 1e3,
        "bound_fp32_by": "operations" if t_ops32 >= t_bytes else "bytes",
        "library_ms": None,
        "timing": "one backward between CUDA events, median of 10 in turns",
        "shape": f"backward: bf16 ({m},{k})@({k},2,{n_b // 2}) GLU-silu: "
                 f"dA ({m},{k}), dB ({k},2,{n_b // 2})",
        "library_call": "none: no single PyTorch call computes the GLU "
                        "epilogue's backward"})
    del a, b, g, out, ref_out

    # K2 at yi-6b's prefill attention of the longest batch (head_dim 128,
    # GQA 32/4); RecurrentGemma's (head_dim 256) comes after K3.
    k2_row(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0, "")

    # K4 at the MoE path's shapes: OLMoE's gate/up projection (the larger
    # of its two expert GEMMs) at the capacity of the 221-token prefill
    # batch (tensor-core tile) and at decode (decode tile), once with every
    # row full and once with the rows of a seeded 4-token top-8 routing, as
    # a served step passes them.  Each is timed as 10 calls replayed from
    # a CUDA graph, as K1; the weights (537 MB, 218 MB for the routed
    # experts) exceed the 50 MB L2.  The routed call's bound counts the
    # bytes of the experts that hold a row, the rows they hold and the
    # whole output, and the operations on those rows.
    e, dm, fe = moe_cfg.moe.n_experts, moe_cfg.d_model, \
        moe_cfg.moe.d_ff_expert
    for tag, tokens, routed in (("prefill", MAX_BATCH * s_max, False),
                                ("decode", MAX_BATCH, False),
                                ("decode, routed", MAX_BATCH, True)):
        c = moe_capacity(moe_cfg, tokens)
        x, w, ep = grouped_case(gen, e, c, dm, 2 * fe, torch.bfloat16,
                                glu=True, act="silu")
        promises = (routed_rows(x, tokens, moe_cfg.moe.top_k, 11) if routed
                    else {})
        fns = {"kernel": lambda: run_grouped(x, w, ep, **promises),
               "plain": lambda: plain_grouped(x, w, ep),
               "library": lambda: torch.bmm(x, w)}
        if routed:      # the same call without the split that max_experts
            fns["unsplit"] = lambda: run_grouped(   # sizes
                x, w, ep, **{**promises, "max_experts": None})
        t = graph_ms(fns)
        tile = grouped_tile_for(x, w, ep)
        _, diff = rel_err(run_grouped(x, w, ep, **promises),
                          plain_grouped(x, w, ep))
        rows = (promises["rows"].cpu() if routed
                else torch.full((e,), c, dtype=torch.int32))
        active, n_rows = int((rows > 0).sum()), int(rows.sum())
        ms, by = bound(2.0 * n_rows * dm * 2 * fe,
                       2.0 * (n_rows * dm + active * dm * 2 * fe
                              + e * c * fe),
                       chip.peak_bf16, chip.hbm_bw)
        kernels.append({
            "name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "grouped_matmul_sm90.cu" if tile == "tc" else
                "grouped_matmul.cu"),
            "replaces": "src/repro/kernels/moe/grouped_matmul.py:21",
            **counts("grouped_matmul"),
            "launches_by_tile": by_tile("grouped_matmul"),
            "tile": tile, "max_abs_err": diff,
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
            "bound_by": by, "library_ms": t["library"],
            **({"ms_without_max_experts": t["unsplit"]} if routed else {}),
            "shape": f"{tag}: bf16 ({e},{c},{dm})@({e},{dm},{2 * fe}) "
                     f"GLU-silu -> ({e},{c},{fe})" + (
                         f", rows of a seeded {tokens}-token top-"
                         f"{moe_cfg.moe.top_k} routing: {active} experts, "
                         f"{n_rows} rows" if routed else ""),
            "library_call": "torch.bmm in bf16 on the full shape (no "
                            "epilogue)"})

    # K1 on int8 with int32 out (exec's prefill tiles; the W8A8 layer's
    # product before its scales) at the w8a8 phase's two products, yi-6b's
    # MLP over the serve traffic's first batch: (884, 4096) @ (4096,
    # 22016), its GLU's gate and up columns, and (884, 11008) @ (11008,
    # 4096); on the SIMT tile, equal to the plain version to the bit and
    # timed as 10 calls replayed from a CUDA graph.  The bound counts one
    # byte an int8 element, 4 an int32 output, and the operations at the
    # int8 peak; the library yardstick is ``torch._int_mm``.
    for tag, (k_, n_) in (("wi", (cfg.d_model, 2 * cfg.d_ff)),
                          ("wo", (cfg.d_ff, cfg.d_model))):
        rows = MAX_BATCH * s_max
        a, b, ep, ops = matmul_case(gen, rows, k_, n_, torch.int8,
                                    out_dtype=torch.int32)
        fns = {"kernel": lambda: run_matmul(a, b, ep, ops),
               "plain": lambda: plain_matmul(a, b, ep, ops)}
        library, why = _int_mm(a, b)
        if library is not None:
            fns["library"] = library
        t = graph_ms(fns)
        tile = tile_for(a, b, ep)
        out, ref = run_matmul(a, b, ep, ops), plain_matmul(a, b, ep, ops)
        same = bool(torch.equal(out, ref))
        if library is not None:
            same = same and bool(torch.equal(library(), ref))
        require(same, f"kernels int8: K1 {tag} differs from its plain "
                "version or torch._int_mm")
        ms, by = bound(2.0 * rows * n_ * k_, rows * k_ + k_ * n_
                       + 4.0 * rows * n_, chip.peak_int8, chip.hbm_bw)
        kernels.append({
            "name": "fused_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gemm_tile.cuh",
            "replaces": "src/repro/kernels/matmul/matmul.py:39",
            **counts("fused_matmul"),
            "launches_by_tile": by_tile("fused_matmul"),
            "tile": tile, "max_abs_err": float((out - ref).abs().max()),
            "bit_equal": same, "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": ms, "bound_by": by,
            "library_ms": t.get("library"),
            "shape": f"{tag}: int8 ({rows},{k_})@({k_},{n_}) -> int32",
            "library_call": why})
        del a, b, out, ref

    # K1 and K4 on fp8 (e4m3fn, e5m2), each on the tile the rule names
    # (SIMT above 8 rows, decode at 8 and fewer), held against the plain
    # version at TOL_FP8 and timed as 10 calls replayed from a CUDA graph:
    # K1 at yi-6b's prefill and decode GLU projection, K4 at OLMoE's
    # gate/up projection at the prefill's capacity and at decode's.  No
    # served path runs fp8: ``launches`` is each kernel's over the paths.
    # The bound counts one byte an fp8 element, 4 an fp32 output, and the
    # operations at the fp8 peak.  The library yardstick is
    # ``torch._scaled_mm`` (one fp32 scale a matrix, the product without
    # the epilogue) where it takes the operands, else none.
    for fmt in FP8:
        name = str(fmt)[6:]
        for tag, rows in (("prefill", MAX_BATCH * s_max),
                          ("decode", MAX_BATCH)):
            a, b, ep, ops = matmul_case(gen, rows, k, n, fmt, glu=True,
                                        act="silu")
            fns = {"kernel": lambda: run_matmul(a, b, ep, ops),
                   "plain": lambda: plain_matmul(a, b, ep, ops)}
            library, why = _scaled_mm(a, b)
            if library is not None:
                fns["library"] = library
            t = graph_ms(fns)
            tile = tile_for(a, b, ep)
            rel, diff = rel_err(run_matmul(a, b, ep, ops),
                                plain_matmul(a, b, ep, ops))
            require(rel <= TOL_FP8, f"kernels fp8: K1 {name} {tag} {rel} "
                    f"against {TOL_FP8}")
            ms, by = bound(2.0 * rows * n * k,
                           rows * k + k * n + 4.0 * rows * n // 2,
                           chip.peak_fp8, chip.hbm_bw)
            kernels.append({
                "name": "fused_matmul", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/" + (
                    "decode_tile.cuh" if tile == "decode" else
                    "gemm_tile.cuh"),
                "replaces": "src/repro/kernels/matmul/matmul.py:39",
                **counts("fused_matmul"),
                "launches_by_tile": by_tile("fused_matmul"),
                "tile": tile, "max_abs_err": diff, "rel_err": rel,
                "tol": TOL_FP8,
                "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
                "bound_by": by, "library_ms": t.get("library"),
                "shape": f"{tag}: {name} ({rows},{k})@({k},{n}) GLU-silu "
                         f"-> ({rows},{n // 2}) fp32",
                "library_call": why})
    for fmt in FP8:
        name = str(fmt)[6:]
        for tag, tokens in (("prefill", MAX_BATCH * s_max),
                            ("decode", MAX_BATCH)):
            c = moe_capacity(moe_cfg, tokens)
            x, w, ep = grouped_case(gen, e, c, dm, 2 * fe, fmt, glu=True,
                                    act="silu")
            t = graph_ms({"kernel": lambda: run_grouped(x, w, ep),
                          "plain": lambda: plain_grouped(x, w, ep)})
            tile = grouped_tile_for(x, w, ep)
            rel, diff = rel_err(run_grouped(x, w, ep),
                                plain_grouped(x, w, ep))
            require(rel <= TOL_FP8, f"kernels fp8: K4 {name} {tag} {rel} "
                    f"against {TOL_FP8}")
            ms, by = bound(2.0 * e * c * dm * 2 * fe,
                           e * c * dm + e * dm * 2 * fe + 4.0 * e * c * fe,
                           chip.peak_fp8, chip.hbm_bw)
            kernels.append({
                "name": "grouped_matmul", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
                "replaces": "src/repro/kernels/moe/grouped_matmul.py:21",
                **counts("grouped_matmul"),
                "launches_by_tile": by_tile("grouped_matmul"),
                "tile": tile, "max_abs_err": diff, "rel_err": rel,
                "tol": TOL_FP8,
                "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
                "bound_by": by, "library_ms": None,
                "shape": f"{tag}: {name} ({e},{c},{dm})@({e},{dm},{2 * fe})"
                         f" GLU-silu -> ({e},{c},{fe}) fp32",
                "library_call": "none: no single PyTorch call multiplies "
                                "a batch of fp8 matrices"})

    # K2 on int8 at yi-6b's prefill attention (causal, head_dim 128; every
    # q head its own KV head: the int8 case the reference's paged route
    # pins), on the SIMT tile: within 1 of the plain version at every
    # element (both truncate toward zero; an fp32 value at a whole number
    # can land one apart), the share that differs reported; the same call
    # through ``paged_flash_attention`` on a shuffled block table equal to
    # the contiguous one bit for bit.  The bound counts one byte an
    # element and the operations at the int8 peak (``bound_fp32_ms``: at
    # the fp32 peak, as the reference computes in fp32); no PyTorch
    # attention takes int8.
    from repro_torch.kernels.attention.paged import (paged_flash_attention,
                                                     to_paged)
    h, hd = cfg.n_heads, cfg.head_dim
    q, kk, v = attention_case(gen, MAX_BATCH, h, h, s_max, s_max, hd,
                              torch.int8)
    q = (q // 16).contiguous()          # scores of a moderate range
    kw = dict(sm_scale=hd ** -0.5, causal=True, window=0, softcap=0.0,
              q_start=0)
    t = graph_ms({"kernel": lambda: run_attention(q, kk, v, **kw),
                  "plain": lambda: plain_attention(q, kk, v, **kw)})
    out = run_attention(q, kk, v, **kw)
    ref = plain_attention(q, kk, v, **kw)
    off = (out.int() - ref.int()).abs()
    kp, vp, table = to_paged(kk, v, PAGED_BLOCK, seed=5)
    paged = paged_flash_attention(q, kp, vp, table, seq_len=s_max, **kw)
    require(out.dtype == torch.int8 and int(off.max()) <= 1,
            f"kernels int8: K2 {int(off.max())} from the plain version")
    require(torch.equal(paged, out), "kernels int8: K2 paged differs from "
            "contiguous")
    pairs = s_max * (s_max + 1) // 2
    flops = 4.0 * MAX_BATCH * h * pairs * hd
    nbytes = 2.0 * q.numel() + kk.numel() + v.numel()
    ms, by = bound(flops, nbytes, chip.peak_int8, chip.hbm_bw)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/attention.py:34",
        **counts("flash_attention"),
        "launches_by_tile": by_tile("flash_attention"),
        "tile": attention_tile_for(q, kk, v),
        "max_abs_err": float(off.max()),
        "share_differing": float((off > 0).float().mean()),
        "paged_bit_identical": True,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by,
        "bound_fp32_ms": bound(flops, nbytes, chip.peak_fp32,
                               chip.hbm_bw)[0],
        "library_ms": None,
        "timing": "per call, median of 10 replays (in turns) of a CUDA "
                  "graph of 10 calls",
        "shape": f"int8 q, k, v ({MAX_BATCH},{h},{s_max},{hd}) causal -> "
                 "int8",
        "library_call": "none: F.scaled_dot_product_attention takes no "
                        "int8"})
    del q, kk, v, kp, vp, out, ref, paged

    # K3 at the W8A8 path's shapes: the fp32 activations of the input
    # projection (the row) and of the output projection (``ff_*``), both
    # on the register path, timed as 10 calls replayed from a CUDA graph
    # (``graph_ms``) over 4 copies of x (4 x 18 MB with the outputs at
    # d_model), so each call's reads are cold; ``single_call_ms`` is the
    # older timing (one call between CUDA events after a 64 MB write, so
    # a call's host time falls inside the window).
    rows, d, ff = MAX_BATCH * s_max, cfg.d_model, cfg.d_ff
    copies = [(torch.randn(rows, d, generator=gen, device="cuda") * 3,)
              for _ in range(4)]
    ff_copies = [(torch.randn(rows, ff, generator=gen, device="cuda") * 3,)
                 for _ in range(4)]
    x = copies[0][0]
    t = graph_ms({"kernel": rotating(run_quant, copies),
                  "plain": rotating(plain_quant, copies),
                  "ff_kernel": rotating(run_quant, ff_copies),
                  "ff_plain": rotating(plain_quant, ff_copies)})
    scratch = torch.empty(16 * 2 ** 20, device="cuda")
    single = time_ms({"kernel": lambda: run_quant(x),
                      "plain": lambda: plain_quant(x)},
                     flush=lambda: scratch.fill_(0.0))
    (q, s), (q_ref, s_ref) = run_quant(x), plain_quant(x)
    diff = max((q.int() - q_ref.int()).abs().max().item(),
               (s - s_ref).abs().max().item())
    ms, by = bound(3.0 * x.numel(), 4.0 * x.numel() + x.numel() + 4.0 * rows,
                   chip.peak_fp32, chip.hbm_bw)
    kernels.append({
        "name": "quantize_rowwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_rowwise.cu",
        "replaces": "src/repro/kernels/quant/quant.py:20",
        **counts("quantize_rowwise"), "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": None,
        "single_call_ms": single["kernel"],
        "single_call_plain_ms": single["plain"],
        "ff_ms": t["ff_kernel"], "ff_plain_ms": t["ff_plain"],
        "ff_bound_ms": bound(3.0 * rows * ff, 5.0 * rows * ff + 4.0 * rows,
                             chip.peak_fp32, chip.hbm_bw)[0],
        "timing": "per call, median of 10 replays (in turns) of a CUDA "
                  "graph of 10 calls over 4 copies of the inputs",
        "shape": f"fp32 ({rows},{d}) -> int8 ({rows},{d}), fp32 ({rows},)"
                 f"; ff_*: fp32 ({rows},{ff})",
        "library_call": "none: no single PyTorch call computes a per-row "
                        "absmax int8 quantisation"})

    # K2 at head_dim 256: RecurrentGemma's prefill attention (MQA 10/1,
    # window 2048, longer than the prompt).
    k2_row(g_cfg.n_heads, g_cfg.n_kv_heads, g_cfg.head_dim, g_cfg.window,
           f", window {g_cfg.window}")
    # K2 at Whisper's shapes (head_dim 64): the encoder's non-causal
    # attention over its 1500 frames (transposed views, as served) and
    # the cross-attention of a decode step, one query row against the
    # 1500 cached keys
    w_cfg = get_config(WHISPER_ARCH)
    wh, wd, ta = w_cfg.n_heads, w_cfg.head_dim, w_cfg.encdec.n_audio_ctx
    k2_row(wh, wh, wd, 0, ", Whisper's encoder", sq=ta, sk=ta,
           causal=False, transposed=True)
    k2_row(wh, wh, wd, 0, ", Whisper's cross-attention at decode", sq=1,
           sk=ta, causal=False)

    # K5 at RecurrentGemma's prefill shape, from a carried state (the
    # stateful pass), timed as K3: graph replays over 4 copies of the
    # inputs (4 x 27 MB with the outputs), and the older single-call
    # timing beside it.  About ten operations per element: exp, expm1,
    # sqrt, three multiplies, an add and the doubling.
    b, c = MAX_BATCH, g_cfg.rnn.d_rnn
    copies = [lru_case(gen, b, s_max, c, h0=True) for _ in range(4)]
    log_a, x, h0 = copies[0]
    t = graph_ms({"kernel": rotating(run_lru, copies),
                  "plain": rotating(plain_lru, copies)})
    single = time_ms({"kernel": lambda: run_lru(log_a, x, h0),
                      "plain": lambda: plain_lru(log_a, x, h0)},
                     flush=lambda: scratch.fill_(0.0))
    _, diff = rel_err(run_lru(log_a, x, h0)[0], plain_lru(log_a, x, h0)[0])
    ms, by = bound(10.0 * x.numel(), 4.0 * (3 * x.numel() + 2 * b * c),
                   chip.peak_fp32, chip.hbm_bw)
    kernels.append({
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/rglru.py:23",
        **counts("rglru_scan"), "max_abs_err": diff,
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": ms,
        "bound_by": by, "library_ms": None,
        "single_call_ms": single["kernel"],
        "single_call_plain_ms": single["plain"],
        "timing": "per call, median of 10 replays (in turns) of a CUDA "
                  "graph of 10 calls over 4 copies of the inputs",
        "shape": f"fp32 log_a, x ({b},{s_max},{c}), h0 ({b},{c}) -> h, h_T",
        "library_call": "none: no single PyTorch call computes the "
                        "recurrence"})

    # K6 at RWKV-6's serving prefill shape (chunk 64, carried state, bf16
    # r, k, v) on the tile the rule names, beside its SIMT tile at the
    # same shape and the plain version, each timed as 10 calls replayed
    # from a CUDA graph (``graph_ms``), as K2: the tensor-core tile's
    # device time is of the order of a call's host time.  Operations of
    # the chunked form on this run's tokens, per (batch, head) and chunk
    # of n tokens: the products the tensor-core tile runs (the inter-chunk
    # product and the state update, 2 n C^2 each, and P V, 2 C a pair of
    # the n(n-1)/2), and the rest in fp32 (a pair's r k, exponent
    # difference, exp and sum: 5 operations a channel; about 12 n C for
    # the prefix sum, the bonus and the scalings).  ``bound_ms`` puts the
    # products at the bf16 tensor-core peak and the rest at the fp32
    # peak, the larger of that and the bytes; ``bound_fp32_ms`` is the
    # reckoning of earlier PRs' rows, every operation at the fp32 peak.
    hh, hs = r_cfg.n_heads, r_cfg.rwkv.head_size
    args = wkv_case(gen, b, hh, s_max, hs, torch.bfloat16, s0=True)
    r, k, v, lw, u, s0 = args
    s_out = torch.empty_like(s0)

    def simt():
        return rwkv6_wkv_simt(r, k, v, lw, u, s0, s_out, chunk=64)
    t = graph_ms({"kernel": lambda: run_wkv(*args, chunk=64),
                  "simt": simt,
                  "plain": lambda: plain_wkv(*args, chunk=64)})
    ref = plain_wkv(*args, chunk=64)[0]
    _, diff = rel_err(run_wkv(*args, chunk=64)[0], ref)
    _, diff_simt = rel_err(simt(), ref)
    tile = wkv_tile_for(r, k, v, lw, chunk=64)
    lens = [min(64, s_max - i) for i in range(0, s_max, 64)]
    pairs = sum(n * (n - 1) // 2 for n in lens)
    mma_ops = b * hh * (4 * s_max * hs * hs + 2 * pairs * hs)
    fp32_ops = b * hh * (5 * pairs * hs + 12 * s_max * hs)
    nbytes = (2 * 4 * r.numel()                  # r, k, v read, o written
              + 4 * (lw.numel() + u.numel() + 2 * s0.numel()))
    t_ops = mma_ops / chip.peak_bf16 + fp32_ops / chip.peak_fp32
    t_bytes = nbytes / chip.hbm_bw
    ms32, by32 = bound(float(mma_ops + fp32_ops), float(nbytes),
                       chip.peak_fp32, chip.hbm_bw)
    kernels.append({
        "name": "rwkv6_wkv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/" + (
            "rwkv6_wkv_sm90.cu" if tile == "tc" else "rwkv6_wkv.cu"),
        "replaces": "src/repro/kernels/rwkv6/rwkv6.py:32",
        **counts("rwkv6_scan"),
        "launches_by_tile": by_tile("rwkv6_scan"),
        "tile": tile, "max_abs_err": diff,
        "ms": t["kernel"], "simt_ms": t["simt"],
        "simt_max_abs_err": diff_simt, "plain_ms": t["plain"],
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_fp32_ms": ms32, "bound_fp32_by": by32,
        "tensor_core_flop": mma_ops, "fp32_flop": fp32_ops, "bytes": nbytes,
        "library_ms": None,
        "timing": "per call, median of 10 replays (in turns) of a CUDA "
                  "graph of 10 calls",
        "shape": f"bf16 r, k, v ({b},{hh},{s_max},{hs}), fp32 lw, u "
                 f"({hh},{hs}), state ({b},{hh},{hs},{hs}), chunk 64",
        "library_call": "none: no single PyTorch call computes the "
                        "recurrence"})
    return kernels


def main() -> int:
    card = phase_device()
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul.ops import fused_matmul
    from repro_torch.kernels.moe.ops import grouped_matmul
    from repro_torch.kernels.rglru.ops import rglru_scan
    from repro_torch.kernels.rwkv6.ops import rwkv6_scan
    cfg, moe_cfg = get_config(ARCH), get_config(MOE_ARCH)
    gemma_cfg = get_config(GEMMA_ARCH)
    g_cfg, r_cfg = get_config(GRIFFIN_ARCH), get_config(RWKV_ARCH)
    w_cfg, iv_cfg, g27_cfg = (get_config(a) for a in (
        WHISPER_ARCH, INTERNVL_ARCH, GEMMA27_ARCH))
    s_max = max(padded_lengths(prompt_lengths()[0]))
    dense = {"fused_matmul": fused_matmul, "flash_attention": flash_attention}
    # K1's launches by tile in each serving path, reckoned from the traffic:
    # 2 batches (prefills at 221 and 90 tokens, each with one logits call
    # at M = 4) and 2 x 15 decode steps, each with one logits call.  Per
    # layer: yi-6b's, gemma2-2b's and OLMoE's attention 4 projections,
    # yi-6b's and gemma2-2b's MLP 2;
    # RecurrentGemma's recurrent blocks 5 and attention blocks 4, MLP 2 on
    # both, and its prefill runs the stack twice; RWKV-6's time mix 7 and
    # channel mix 3.
    steps = N_REQUESTS // MAX_BATCH * (MAX_NEW - 1)

    def reckon(per_pass, passes=1, logits=1):
        """``per_pass``: calls in one pass over the stack; ``logits``: K1's
        logits call after each pass (K4 has none)."""
        return {"tc": 2 * passes * per_pass,
                "decode": steps * (per_pass + logits) + 2 * logits,
                "simt": 0}
    g_attn = sum(1 for i in range(g_cfg.n_layers) if i % 3 == 2)
    k1_tiles = {
        "serve": reckon(6 * cfg.n_layers),
        "moe-serve": reckon(4 * moe_cfg.n_layers),
        "griffin-serve": reckon(7 * (g_cfg.n_layers - g_attn) + 6 * g_attn,
                                passes=2),
        "rwkv-serve": reckon(10 * r_cfg.n_layers),
        "gemma-serve": reckon(6 * gemma_cfg.n_layers),
        "internvl-serve": reckon(6 * iv_cfg.n_layers),
        "gemma27-serve": reckon(6 * g27_cfg.n_layers)}
    # Whisper: a prefill runs the encoder (6 calls a layer, on 4 x 1500
    # rows), each decoder layer's cross K and V on the encoder's output
    # (2) and the decoder over the prompt (self q, k, v, o, cross q, o and
    # the MLP's 2: 8 a layer), all on the tensor-core tile, then the
    # logits; a decode step the decoder's 8 a layer and the logits:
    # 2 x (24 + 8 + 32) = 128 tc, 30 x 33 + 2 = 992 decode
    w_enc, w_dec = w_cfg.encdec.n_encoder_layers, w_cfg.n_layers
    k1_tiles["whisper-serve"] = {
        "tc": 2 * (6 * w_enc + 2 * w_dec + 8 * w_dec),
        "decode": steps * (8 * w_dec + 1) + 2, "simt": 0}
    # K4: both expert GEMMs of every OLMoE layer, the prefills' (C = 144
    # and 64) on the tensor-core tile, the decode steps' (C = 8) on the
    # decode tile: 64 tc and 960 decode launches
    k4_tiles = reckon(2 * moe_cfg.n_layers, logits=0)
    # K2: one prefill call an attention layer, a pass and a batch, all bf16
    # at head_dim 128 or 256 on the tensor-core tile: yi-6b 32 x 2 = 64,
    # OLMoE 16 x 2 = 32, RecurrentGemma 8 x 2 passes x 2 = 32, gemma2-2b
    # 26 x 2 = 52
    k2_tiles = {
        "serve": {"tc": 2 * cfg.n_layers, "simt": 0},
        "moe-serve": {"tc": 2 * moe_cfg.n_layers, "simt": 0},
        "griffin-serve": {"tc": 2 * 2 * g_attn, "simt": 0},
        "gemma-serve": {"tc": 2 * gemma_cfg.n_layers, "simt": 0},
        "internvl-serve": {"tc": 2 * iv_cfg.n_layers, "simt": 0},
        "gemma27-serve": {"tc": 2 * g27_cfg.n_layers, "simt": 0},
        # Whisper: a prefill's encoder, decoder self- and cross-attention
        # (4 + 4 + 4) and every decode step's cross-attention, one query
        # row against 1500 keys (4): 2 x 12 + 30 x 4 = 144
        "whisper-serve": {"tc": 2 * (w_enc + 2 * w_dec) + steps * w_dec,
                          "simt": 0}}
    # K6: one call a time-mix layer and a prefill, bf16 at head size 64 on
    # the tensor-core tile: 32 x 2 = 64 (a decode step runs the oracle's
    # single step, no K6)
    k6_tiles = {"tc": 2 * r_cfg.n_layers, "simt": 0}
    # phase plan's pricing, host only, runs beside the build and the
    # kernels' checks
    pricing = start_pricing(cfg, plan_sweeps())
    try:
        phase_build()
        served = {ARCH: served_k1_calls(ARCH, 1),
                  MOE_ARCH: served_k1_calls(MOE_ARCH, 1),
                  GRIFFIN_ARCH: served_k1_calls(GRIFFIN_ARCH, 3),
                  RWKV_ARCH: served_k1_calls(RWKV_ARCH, 1),
                  GEMMA_ARCH: served_k1_calls(GEMMA_ARCH, 2),
                  # at the served rows: Whisper whole, one internvl2-1b
                  # layer, one gemma2-27b (local, global) pair
                  WHISPER_ARCH: served_k1_calls(WHISPER_ARCH, w_dec, s_max),
                  INTERNVL_ARCH: served_k1_calls(
                      INTERNVL_ARCH, 1, iv_cfg.vision_prefix + s_max),
                  GEMMA27_ARCH: served_k1_calls(GEMMA27_ARCH, 2, s_max)}
        phase_kernels(cfg, moe_cfg, gemma_cfg, s_max, served,
                      train_k1_calls())
        phase_kernels_recurrent(g_cfg, r_cfg, s_max)
        phase_parity(ARCH, "parity")
        phase_parity(MOE_ARCH, "moe-parity")
        phase_parity(GRIFFIN_ARCH, "griffin-parity", GRIFFIN_PARITY_LAYERS)
        phase_parity(RWKV_ARCH, "rwkv-parity")
        phase_parity(ARCH, "parity-bf16", dtype=torch.bfloat16,
                     tol=TOL_PATH_BF16)
        phase_parity(MOE_ARCH, "moe-parity-bf16", dtype=torch.bfloat16,
                     tol=TOL_PATH_BF16)
        launches = {
            "serve": phase_serve(ARCH, "serve", dense,
                                 {"fused_matmul": k1_tiles["serve"],
                                  "flash_attention": k2_tiles["serve"]}),
            "moe-serve": phase_serve(MOE_ARCH, "moe-serve", {
                **dense, "grouped_matmul": grouped_matmul},
                {"fused_matmul": k1_tiles["moe-serve"],
                 "grouped_matmul": k4_tiles,
                 "flash_attention": k2_tiles["moe-serve"]}),
            "griffin-serve": phase_serve(GRIFFIN_ARCH, "griffin-serve", {
                **dense, "rglru_scan": rglru_scan},
                {"fused_matmul": k1_tiles["griffin-serve"],
                 "flash_attention": k2_tiles["griffin-serve"]}),
            "rwkv-serve": phase_serve(RWKV_ARCH, "rwkv-serve", {
                "fused_matmul": fused_matmul, "rwkv6_scan": rwkv6_scan},
                {"fused_matmul": k1_tiles["rwkv-serve"],
                 "rwkv6_scan": k6_tiles}),
            "exec": phase_exec(cfg, s_max, card)}
        phase_profile(ARCH, "profile", s_max, host_cost=True)
        phase_profile(MOE_ARCH, "moe-profile", s_max)
        phase_profile(GRIFFIN_ARCH, "griffin-profile", s_max)
        phase_profile(RWKV_ARCH, "rwkv-profile", s_max)
        launches["paged"] = phase_paged(cfg, g_cfg, s_max)
        phase_parity(GEMMA_ARCH, "gemma-parity")
        launches["gemma-serve"] = phase_serve(
            GEMMA_ARCH, "gemma-serve", dense,
            {"fused_matmul": k1_tiles["gemma-serve"],
             "flash_attention": k2_tiles["gemma-serve"]})
        for arch, tag, layers in (
                (WHISPER_ARCH, "whisper", w_dec),
                (INTERNVL_ARCH, "internvl", INTERNVL_PARITY_LAYERS),
                (GEMMA27_ARCH, "gemma27", GEMMA27_PARITY_LAYERS)):
            phase_parity(arch, f"{tag}-parity", layers)
            launches[f"{tag}-serve"] = phase_serve(
                arch, f"{tag}-serve", dense,
                {"fused_matmul": k1_tiles[f"{tag}-serve"],
                 "flash_attention": k2_tiles[f"{tag}-serve"]})
        # gemma2-27b's decode step reads 54.45 GB of weights: where its
        # time goes against that bytes bound
        phase_profile(GEMMA27_ARCH, "gemma27-profile", s_max)
        # the launcher's 6 requests make 2 batches (of 4 and 2, prompts
        # of 13 and 15 padded tokens, K1's tensor-core tile) and 2 x 15
        # decode steps, as the serve traffic does: the same reckoning
        launches["plan"] = phase_plan(
            cfg, {"fused_matmul": k1_tiles["serve"],
                  "flash_attention": k2_tiles["serve"]}, pricing)
        launches["tune"] = phase_tune(cfg)
        phase_online(cfg)
        launches["w8a8"] = phase_w8a8(cfg, s_max)
        launches["train-parity"] = phase_train_parity()
        launches["train"] = phase_train(card)
        # OLMoE served expert-parallel: each rank runs moe-serve's calls,
        # K4 over its half of the experts
        launches.update(phase_dist(s_max, {
            "fused_matmul": k1_tiles["moe-serve"],
            "grouped_matmul": k4_tiles,
            "flash_attention": k2_tiles["moe-serve"]}))
        # yi-6b served tensor-parallel and trained with FSDP and tensor
        # parallelism on DIST_MESH_RANKS ranks
        launches.update(phase_dist_mesh())
        # yi-6b served on 8 ranks, its 4 KV heads' cache shared out along
        # the sequence
        launches.update(phase_dist_seq())
        # RecurrentGemma-2B, RWKV-6-7B and whisper-tiny served and trained
        # on DIST_REC_RANKS ranks: K5 on each rank's channels, K6 on its
        # heads
        launches.update(phase_dist_rec())
        # OLMoE-1B-7B served under GSPMD expert parallelism on 4 ranks of
        # (data 2, model 2): K4 on each rank's 32 experts and 512 d_ff
        # columns at the whole batch's capacity
        launches.update(phase_dist_gspmd())
        # every family under the reference's {"seq": "model"} rules on
        # DIST_SP_RANKS ranks: K1, K2, K4, K5 and K6 on each rank's
        # gathered sequence
        launches.update(phase_dist_sp(card))
        # the placements no experiment's rules give, on DIST_FORMS_RANKS
        # ranks of (data 2, model 2): each run one change of a key of the
        # default rules; K1 on every rank, K4 and K6 on their models'
        launches.update(phase_dist_forms(card))
        launches["dryrun"] = phase_dryrun(card)
        # the six port-side examples at the reference scripts' sizes and
        # the roofline report: K1, K2, K5 and K6
        launches["examples"] = phase_examples(card)
        kernels = phase_timing(cfg, moe_cfg, g_cfg, r_cfg, s_max, launches)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        pricing[0].terminate()
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
