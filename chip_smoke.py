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
                serves it (``launches_by_tile``);
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
20. the ``kernels`` line: per kernel, its launches in the paths above, its
   time at the paths' largest shapes beside its plain version, a library
   call and its roofline bound; K1 at prefill (tensor-core tile), decode
   and logits (decode tile), K4 at prefill (tensor-core tile), at decode
   with every row full and with a seeded routing's rows (decode tile), K2
   at head_dim 128 and 256 and at Whisper's encoder and cross-attention
   decode shapes (head_dim 64), and K6 at RWKV-6's prefill shape
   (tensor-core tiles, beside the SIMT tiles at the same shapes), timed
   from CUDA-graph
   replays; K3 and K5 from CUDA-graph replays over copies of their inputs
   that together exceed the L2 (``rotating``), with the older single-call
   timing beside it.

Each path's launch counts are set to 0 just before it runs and read just
after.  The last line is ``{"ok": true, "device": {...}}``.  Any failed
phase exits non-zero before it.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
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


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def rel_err(out, ref):
    """(max |out - ref| / max |ref|, max |out - ref|) in float64."""
    o, r = out.double(), ref.double()
    diff = (o - r).abs().max().item() if o.numel() else 0.0
    scale = r.abs().max().item() if r.numel() else 0.0
    return diff / (scale + 1e-30), diff


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
                  out_dtype=out_dtype or (torch.float32 if dtype ==
                                          torch.int8 else dtype))
    return a, b, ep, ops


def run_matmul(a, b, ep, ops):
    from repro_torch.kernels.matmul.ops import fused_matmul
    return fused_matmul(a, b, epilogue=ep, operands=ops)


def plain_matmul(a, b, ep, ops):
    from repro_torch.kernels.matmul.matmul import fused_matmul_plain
    acc = torch.int32 if a.dtype == torch.int8 else torch.float32
    return fused_matmul_plain(a, b, ep, ops, acc)


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
        torch.int32 if dtype == torch.int8 else dtype))
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
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.models.base import family_module
    cfg = get_config(arch).with_(n_layers=n_layers)
    mod = family_module(cfg)
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = mod.init(cfg, gen, "cuda")
    b, s = (1, 16) if prompt is None else (MAX_BATCH, prompt)
    calls = {}
    inner = mm_ops.fused_matmul_cuda      # the wrapper's 2-D launch

    def recording(a, b_, ep, ops):
        rows = None if prompt is None else a.shape[0]
        calls[(rows, a.shape[1], b_.shape[1], ep.glu, ep.activation,
               ep.softcap, ep.bias_type.name.lower(), ep.out_dtype)] = None
        return inner(a, b_, ep, ops)

    mm_ops.fused_matmul_cuda = recording
    try:
        tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda")
        cache = mod.init_cache(cfg, b, s + 16, device="cuda")
        logits, cache = mod.prefill(
            cfg, params, {"tokens": tokens, **stub_inputs(cfg, b, gen)},
            cache)
        mod.decode_step(cfg, params, logits.argmax(-1)[:, None], cache, s)
        torch.cuda.synchronize()
    finally:
        mm_ops.fused_matmul_cuda = inner
    del params, cache
    torch.cuda.empty_cache()
    s_max = max(padded_lengths(prompt_lengths()[0]))
    return [((4 * s_max, MAX_BATCH) if rows is None else (rows,), *call)
            for rows, *call in calls]


def phase_kernels(cfg, moe_cfg, gemma_cfg, s_max, served):
    """``served``: arch -> its distinct K1 calls (``served_k1_calls``)."""
    from repro_torch.configs.registry import get_config
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
    emit({"phase": "kernels", "cases": results})
    require(all(r["ok"] for r in results),
            "kernel mismatch: " + ", ".join(r["case"] for r in results
                                           if not r["ok"]))
    return results


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
                  _to_fp32(params))
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
    n_params = sum(x.numel() for x in _leaves(params))

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


def phase_plan(cfg, launcher_reckoned):
    """Planning-only ``ServingEngine(cfg, None)``s (yi-6b at full width
    and depth) price the launcher's traffic (``PLAN_PROMPTS``) in each of
    ``PLAN_CASES`` and the serve traffic (``serve_prompts``) in each of
    ``PLAN_SERVE_CASES``, requests arriving every ``PLAN_ARRIVAL_GAP``
    cycles (``price_cases``: equal to the reference's ``REFERENCE``,
    recorded by ``scripts/record_smoke_constants.py``).  The launcher
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
    eng = plan_engine(cfg, PLAN_PROMPTS)
    sweep, sweep_s = price_cases(cfg, eng, PLAN_CASES, ref)
    serve_sweep, serve_sweep_s = price_cases(
        cfg, plan_engine(cfg, serve_prompts()), PLAN_SERVE_CASES,
        REFERENCE["plan_serve"])

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


def _to_fp32(tree):
    """A copy of a parameter tree with its floating tensors in fp32."""
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_fp32(v) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.float()
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Times at the paths' largest shapes.
# ---------------------------------------------------------------------------

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
        phase_kernels(cfg, moe_cfg, gemma_cfg, s_max, served)
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
                  "flash_attention": k2_tiles["serve"]})
        launches["tune"] = phase_tune(cfg)
        phase_online(cfg)
        launches["w8a8"] = phase_w8a8(cfg, s_max)
        kernels = phase_timing(cfg, moe_cfg, g_cfg, r_cfg, s_max, launches)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
