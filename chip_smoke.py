"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path on one NVIDIA GPU and checks it:

1. card     — print ``nvidia-smi`` name and power limit; fail without CUDA;
2. build    — build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels  — K1 (paged decode attention) and K2 (flash attention) against
              their plain PyTorch versions at the main path's shapes, in
              bf16, then timed with CUDA events beside the plain version and
              a library yardstick the port never calls, eagerly and as
              device time in a CUDA graph; each report adds its ptxas
              registers / shared memory / spills, SASS instruction counts,
              TFLOP/s, % of its bound, time over the library's and (K1) the
              wrapper's host time per call; K1 is also rebuilt with a
              shallower cp.async ring and with its block table read
              through __ldg only (no shared copy), and timed in turns
              beside itself (an ablation);
4. serve    — stablelm-1.6b at full width (24 layers, random weights from a
              seeded ``torch.Generator``) through ``ServeEngine``, whose
              decode chunk is one captured CUDA graph replayed per chunk:
              8 staggered requests of mixed prompt lengths, 32 new tokens
              each, with every kernel's launch count read around the run
              (K1's exactly one per layer and step, added by each replay);
              then a frozen mid-run chunk through the graph and through the
              same body eagerly on the engine's own tensors (tokens and
              carry equal, the written pool compared), and its device time
              both ways (CUDA events behind a ``torch.cuda._sleep``) beside
              the host's enqueue time of each;
5. steps    — one ``decode_step_paged`` on a frozen copy of the engine's
              pool and tables with K1 and with the gather oracle, and one
              ``prefill`` with K2 and with the plain path; logits compared;
5a. async   — the port's serve suite (``bench/serve_continuous.py``) at
              stablelm-1.6b's full width and depth with the same weights:
              the continuous trace (``choice`` lengths 16/24/32, 32 new
              tokens, decode chunk 8, block 8, a 16-token window, Poisson
              at 20 Hz, 104 requests) in three modes — eager-sync (the
              eager chunk), graph-sync (the default), graph-async (the
              async decode lookahead): in fp32 compute at full width and 4
              layers their tokens must be equal, with PyTorch's stream
              syncs counted by engine function; in bf16 at full depth one
              warmed engine per mode, two rounds in turns, each run held to
              the suite's gates below, its launches counted, and per mode
              tok/s, TTFT and admission p50/p99 and the mean cycle split
              (dispatch, sync, bookkeeping, gap) printed, with a JSON line
              of them; async-vs-sync token equality in bf16 is printed;
5b. prefix  — the prefix-share trace (4 prefixes of 96 tokens x
              4-8-token suffixes, 24 requests, 16 new tokens, 80 blocks of
              8) cold and warm, each with an ``Observability`` and its
              Chrome trace in ``build/prefix/``; each run (and each run of
              the async phase) fails unless every request returns in-vocab tokens,
              ``serve.ttft_s.count`` equals the requests, the trace has
              engine, slot and line spans, every slot is free and every
              block is free at refcount 0 once the trie is evicted; the
              warm run must hit, save prefill tokens and fork, K1 must run
              in both; warm tokens must equal cold in fp32 compute at full
              width and 4 layers (and the cold pass on the eager chunk the
              captured chunk's), and their bf16 match share and first
              flip's top-2 margin are printed; the obs gate's on/off ratio
              is printed (not gated);
5c. slo     — SLO overload control and failure isolation (``bench/
              serve_slo.py``): the ``serve_slo`` suite at the reference's
              non-quick shapes on stablelm-1.6b at full width and depth
              (bf16, the serve phase's weights), graph-sync and
              graph-async in two rounds in turns: tier-0 TTFT p50/p99
              alone and under the tier-1
              flood, their p99 ratio (reported), shed / expired /
              preempted and the outcomes by tier, with contended ``shed +
              expired > 0`` asserted, every future ending in in-vocab
              tokens or a typed ServeError and every slot and block free;
              K1 and K2 counted. In fp32 compute at full width and 4
              layers, in both graph modes: the benign fault spec keeps
              every request's tokens; ``chunk_sync_exc`` fails seated rows
              ``RowFailed`` while the one capture keeps replaying (later
              tokens a fresh engine's); ``chunk_latency`` past
              ``watchdog_s`` raises ``WatchdogTimeout`` within ~2x the
              budget; a JSON line ``{"slo_modes": ...}``;
5d. durable — durable serving on the same weights (bf16, prefix cache,
              captured chunk, sync and async): the prefix-share trace,
              ``drain()``, ``snapshot()`` (bytes, seconds, host bytes
              moved), a fresh engine's in-place ``restore()`` (pool
              address and graph unchanged) whose first request of a known
              prefix hits warm, its TTFT beside a cold engine's; a flipped
              byte raises ``SnapshotCorrupt`` and recovers cold; in fp32 at
              full width and 4 layers a restored engine's tokens equal a
              fresh one's; ``drain(deadline_s=0.02)`` with rows seated
              preempts them (sync and async), the snapshot queues every
              unfinished request, ``close()`` fails them typed and a
              restored engine resubmitting them gives an uninterrupted
              run's tokens; a subprocess on the card
              (``repro_torch.launch.incarnation``) killed by
              ``crash_at:at=3`` (sync and async side by side) is recovered
              by a fresh process with an uncrashed run's tokens;
              ``journal_gate`` (``--quick``) within its 5% budget, with
              each mode's prefill groups; a JSON line
              ``{"durable": ...}``;
5e. percall — the per-call contiguous-decode baseline: in fp32 at full
              width and 4 layers ``lm.decode_step`` against
              ``decode_step_paged`` (K1) per step, and
              ``_generate_grouped``'s tokens equal the resident engine's;
              then the serve suite with its per-call arm on a 24-request
              trace (bf16, full depth): per-call tok/s and latency
              p50/p99 beside the continuous engine's, a JSON line
              ``{"percall": ...}``; then stablelm's weights are freed;
6. k3       — K3 (the Mamba1 selective scan) against its plain sequential
              version at the SSM prefill path's shapes (B=1, dI=8192, N=16,
              S in {16, 57, 300}, bf16 x/B/C, fp32 dt), a ragged, a B=4, an
              fp32-input and an initial-state case, then timed beside its
              bound and the plain version, eagerly and in a CUDA graph (no
              PyTorch call computes a selective scan, so it has no library
              time), with the same report as K1's, and rebuilt with parts of
              its design changed and timed (an ablation);
7. ssm      — falcon-mamba-7b at full width (64 layers, d_model 4096,
              d_inner 8192, random weights from a seeded
              ``torch.Generator``) through ``ServeEngine``'s slot-state
              pool: the same 8 staggered requests, 32 new tokens each, with
              the launch counts read around the run, and a frozen chunk
              through the graph and eagerly (tokens equal); after
              ``ssmstep``, checkpoint preemption (``preempt:every=3``,
              graph-sync, fp32 at full width and 4 layers): tokens equal
              the fault-free run's, one prefill per request;
8. ssmstep  — one ``prefill`` of the 300-token prompt with K3 and with the
              plain scan, in bf16 and in fp32 compute: logits and the
              returned SSM states compared; then the weights are freed;
8a. hybrid  — zamba2-1.2b at full width and depth (38 Mamba2 layers,
              d_model 2048, d_inner 4096, 64 SSD heads, one shared
              attention block after every 6 layers; random weights from a
              seeded ``torch.Generator``) through ``ServeEngine``'s
              slot-state pool: the same 8 staggered requests, with K2's
              launches (the shared block's prefill attention, 6 per
              prefill) read around the run, and a frozen chunk through the
              graph and eagerly (tokens equal); after ``hybridstep``,
              checkpoint preemption as for falcon-mamba (fp32, 8 layers:
              one shared-attention group and the 2-layer tail);
8b. hybridstep — K2 against its plain version at the shared block's
              prefill shape (B=1, S=300, H=KV=32, hd=64, bf16 and fp32) and
              timed; one ``prefill`` of the 300-token prompt (one ragged
              SSD chunk) and of a 256-token prompt (two chunks) with K2 and
              with the plain chunked attention, in bf16 and in fp32
              compute: logits and the four returned state leaves compared;
              and one Mamba2 layer at full width in fp32, its SSD dual form
              over 256 tokens against 256 single-token recurrence steps
              from a zero state; then the weights are freed;
8c. moe     — qwen2-moe-a2.7b at full width and depth (24 layers, d_model
              2048, 16 heads of 128, 60 experts top-4 of F=1408 plus
              shared experts of 5632, vocab 151936; random weights from a
              seeded ``torch.Generator``, 28.6 GB with the matrices in
              bf16) through ``ServeEngine``'s paged pool: the same 8
              staggered requests, with K1's and K2's launches read around
              the run, the frozen chunk through the graph and eagerly, and
              its device time both ways;
8d. moestep — K1 (B=8, H=KV=16, hd=128) and K2 (B=4, S=T=128, H=KV=16,
              hd=128) against their plain versions and timed beside SDPA
              and their bound; the ``steps`` checks on a frozen copy of
              the engine's pool, in bf16 at full depth and in fp32 compute
              at full width and 8 layers; the share of assignments the
              window-0 prefill drops over capacity; ``moe_layer`` twice on
              one CUDA input, bitwise equal; then the weights are freed;
8e. train   — stablelm-1.6b at full width and depth (fp32 masters from a
              seeded ``torch.Generator``, AdamW with fp32 moments, bf16
              compute with remat) trained through the port's ``Trainer``
              (the cyclic conditional taskflow) for 3 steps of 8 x 2048
              tokens, cut from the ``full`` preset's 256 x 4096: step
              walls, tok/s, MFU, peak memory and the loss curve; then a
              step under ``set_sync_debug_mode("error")``, a step traced
              with ``torch.profiler`` (device busy, launches, kernels by
              class), the ``ckpt-save`` snapshot timed (not written); bf16
              against fp32 compute at full width and 4 layers; the
              checkpoint branch with an injected failure at smoke size.
              No kernel of the port runs here: training takes the plain
              chunked attention, as the reference does;
8f. k3bwd   — the backward kernel of K3 (``csrc/mamba_scan_bwd.cu``,
              behind ``MambaScan``) against autograd through the plain
              sequential scan: B=2, S=250 (off the 32-step chunks), dI=512,
              N=16 in fp32 and with bf16 x/B/C, a ragged dI with an initial
              state and a final-state gradient, N=12; its recomputed
              states against K3's, bit for bit; then at the training shape
              (B=1, S=2048, dI=8192, N=16) compared again, two calls
              bitwise equal, timed beside its bound and the plain
              backward, with K3's serving and training entry points timed
              there too; registers and resident blocks per SM;
8g. train_ssm — in fp32 at full width, one batch's loss and every
              gradient on the card against the CPU's (falcon-mamba-7b at 4
              layers, zamba2-1.2b at 14: two groups and a 2-layer tail);
              then 2 steps of 8 x 2048 through the ``Trainer`` (fp32
              masters, bf16 compute with remat) for zamba2-1.2b at full
              width and depth and falcon-mamba-7b at full width cut to 16
              of 64 layers: step walls, tok/s, MFU, peak memory and a
              traced step (idle share, time by kernel class: K3, its
              backward, GEMMs), K3 and backward launches counted;
8h. frontend — the modality-frontend archs with seeded stub frames: in
              fp32 at full width and 4 layers, the prefill through K2
              against the chunked plain path and decode-after-prefill
              against ``forward`` (internvl2-1b, musicgen-large);
              internvl2-1b at full width and depth trained 2 steps of 8 x
              2048 tokens behind its 256 frames; musicgen-large at full
              width and depth (bf16): 8 prompts of 64 tokens behind its 64
              frames prefilled through K2, then 16 greedy ``decode_step``s;
9. k4       — K4 (the LSDNN layer) against its plain version at the HPEC
              shape T=60000, F=G=1024 (fp32 and bf16, random and HPEC
              data), at ragged shapes and at a cap-saturating case, then
              timed beside its bound, the plain version and
              ``torch.addmm`` + ``clamp_``, with the same report as K2's
              (its SASS: cp.async and FFMA, no HMMA), and timed again
              beside copies of it built without its y copies, without
              any copies and without copies or barriers (what its time
              is made of);
10. lsdnn   — the paper's sparse-DNN workload (``bench/fig13_lsdnn.py``,
              HPEC configuration: 60,000 rows x 1024 neurons x 120 layers,
              2 chained passes) through its sequential, unrolled and
              taskflow paths (the taskflow path: the condition-task cycle
              on the port's Executor, one CUDA-graph replay per pass), with
              K4's launches read around the run; outputs and categories
              checked across the paths and against the plain version;
11. device  — a DEVICE task (saxpy) through the Executor on the card,
              checked against numpy;
11a. condgraph — in-graph conditional tasking (``CondGraph``, one CUDA
              graph with a WHILE node and an IF node per block,
              ``kernels/csrc/cond_graph.cu``): the programs of
              ``tests/test_jaxgraph.py`` with torch state, a bounded fig17
              loop (x at unit spectral norm, k = 256) and a loop that stops
              on a device-side norm test, each compiled on the card and
              held to ``lower()`` on the card and on the CPU (integers
              exact, fp32 rel <= 1e-5), one graph launch per call, a call
              under ``set_sync_debug_mode("error")``, a second call on
              re-bound state, ``max_iters`` and an out-of-range index as on
              the CPU (``bench/condgraph_check.py``); fig17's device panel
              (nodes at k = 8 and 256, capture, replay and pool bytes of
              the WHILE program and the unrolled graph, the host-driven
              loop); then a quick pass of ``bench.run --only
              table2,fig9,fig17,paged_decode --quick`` whose
              ``BENCH_*.json`` must hold each suite's row names
              (paged_decode runs K1 at stablelm-1.6b's full-width heads);
11b. examples — the port's examples on the card at their default sizes
              (``src/repro_torch/examples``): ``quickstart``,
              ``placement_loop`` (4,096 cells, 8,192 nets: its wirelength
              must fall), ``serve_lm`` (qwen3-14b's smoke config: its three
              demos), ``train_lm`` (20 steps: the loss finite and falling,
              then a greedy decode through the engine) and
              ``lsdnn_inference`` (48 layers of 512: the rows carry the
              reference's names, the paths agree); K1, K2 and K4 launches
              counted;
11c. nested — a DeviceFlow that nests a compiled ``CondGraph`` (the
              data-dependent loop x <- m @ x until |x| < 1e-3, d = 256,
              three scales of x: three trip counts) between two ops of its
              own: one replay per offload, equal to the same ops around
              ``lower()`` run eagerly on the card (trips exact, fp32 rel
              1e-5), and the program's launch counts unchanged by every
              replay (``bench/condgraph_check.py``);
11d. mesh   — tensor-parallel serving: stablelm-1.6b at full width on two
              ``gloo`` ranks sharing the one card (this process and one
              spawned follower, 16 of its 32 KV heads a rank): the 8
              staggered requests through the 2-rank engine and the
              single-device engine, in fp32 compute at 4 layers (tokens
              must be equal; TF32 off) and in bf16 at full depth (the share
              of equal tokens and the first flip's top-2 margin printed);
              each rank's pool half the single-device pool, no all-reduce
              and every decode-chunk all-gather below half a pool shard;
              tok/s and the decode cycle of both engines, printed as
              host-staged ``gloo`` numbers, not a tensor-parallel speed;
              the ranks' K1 and K2 launches counted over each 2-rank
              engine's life, warm-up included, on both ranks (the
              follower's reported back per engine); a failed rank fails
              the phase with its traceback; then a single-device engine
              whose every product a rank holds a column slice of is
              computed slice by slice (``bench/serve_mesh.py::
              column_slice_params``): its bf16 tokens and a 64-token
              prefill's logits against the 2-rank run's and the single
              engine's, with ``allow_bf16_reduced_precision_reduction`` on
              both ranks;
11e. train_mesh — sharded training on two ``gloo`` ranks sharing the card
              (one ``MeshSession``, a (2, 1) mesh; ``bench/train_mesh.py``):
              stablelm-1.6b at full width in fp32 at 4 layers, one step of
              2 x 2048 against the single-device step (metrics, moments,
              params within TRAIN_MESH_TOL); in bf16 with remat at 2 layers
              (cut from 24 for time), 2 steps of 4 x 2048 (two microbatches
              of one sequence a rank) with the weight gather hoisted and not
              (half the all-gathers hoisted); falcon-mamba-7b at full width
              and 2 of 64 layers, one bf16 step of 2 x 2048, K3 and its
              backward launched on both ranks and counted. Then a (1, 2)
              mesh, whose step partitions its products over ``model``:
              the fp32 stablelm step again against the single-device step,
              no leaf all-gathered; falcon-mamba-7b at 4 layers, K3 and its
              backward launched on each rank's 4,096 channels; K3 and its
              backward timed at dI 4,096 and 8,192; qwen2-moe-a2.7b at full
              width and 2 layers (``moe-tp``: 30 of 60 experts a rank, the
              shared experts column- and row-parallel): an fp32 step of 2 x
              2048, each rank's blocks against the same blocks of the
              single-device step, run on the card by each rank in turn
              (nothing gathered), and 2 bf16 steps whose losses move; no
              leaf all-gathered, each rank's expert leaves 30 experts a
              layer. Each rank's parameter
              and moment bytes must be each leaf's over the ranks its spec
              shards it across; peak memory a rank, collectives by kind and
              step walls (host-staged, not a speed) are printed, with a
              JSON line ``{"train_mesh": ...}``;
11f. mesh_durable — durable serving, failure isolation and the per-call
              baseline under the group: stablelm-1.6b at full width in fp32
              at 4 layers on two ``gloo`` ranks sharing the card against
              the single-device engine: with the journal and the prefix
              cache, tokens and journal records (timestamps aside) equal,
              the snapshot's bytes equal to those of the single-device
              engine that computes the ranks' column slices, and to the
              plain single engine's but for KV pages within 1e-5 of
              their largest magnitude (cuBLAS's fp32 kernels differ by
              the GEMM's width); a fresh 2-rank engine restored from the
              snapshot serves a known prefix warm with the same tokens;
              ``chunk_sync_exc:at=2`` fails the same two requests
              ``RowFailed`` and the later tokens are equal; the per-call
              baseline's tokens are equal; a 2-rank incarnation killed by
              ``crash_at:at=3`` takes its follower down and a fresh 2-rank
              incarnation recovers an uncrashed engine's tokens; snapshot
              and restore seconds printed, a JSON line
              ``{"mesh_durable": ...}``;
11g. dryrun — the dry run (``repro_torch.distributed.op_analysis``: the
              step on the meta device, nothing launched) set beside the
              train phases: stablelm-1.6b's single-device step at 8 x 2048
              predicts the trainer's state and batch bytes exactly, its
              predicted peak printed beside ``max_memory_allocated``; the
              predicted collectives of train_mesh's runs equal its live
              counters (both ranks' on the (1, 2) mesh, whose FLOPs a rank
              must be half one device's); a JSON line ``{"dryrun": ...}``;
12. report  — one JSON line of per-kernel numbers (K1-K4, K3's backward
              and ``cond_graph``), the card line, and the final
              ``{"ok": true, ...}`` line.

    python3 chip_smoke.py
    python3 chip_smoke.py --other-csrc build/parent/src/repro_torch/kernels/csrc
    python3 chip_smoke.py --k3bwd-ablations

The second form adds another tree's K1, K3 and K3's backward (e.g. the
parent commit's, unpacked with ``git archive <commit>
src/repro_torch/kernels/csrc | tar -x -C build/parent``) to their
ablations: built from its sources, timed in turns beside this tree's in
CUDA graphs (K3's backward with its registers, and its resident blocks per
SM where its build reports them). The third takes K3's backward apart:
copies built without its d-sum tile, its B/C or a_t loads, or its second
half-chunk recompute, timed in turns beside it.

Exits non-zero, without the final line, when a phase fails or CUDA is
unavailable. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import ctypes
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate, bf16 tensor rate
# (K1, K2) and fp32 rate outside the tensor cores (K3, K4, whose fp32
# arithmetic is exact)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
# exponentials per second (K3): the special function units give 16 results
# per clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), at the 1.98 GHz boost clock behind
# the data sheet's 67 TFLOP/s (132 SMs x 128 fp32 lanes x 2 x 1.98 GHz)
SFU_EXP_PER_S = 132 * 16 * 1.98e9

# tolerances (absolute, bf16 outputs of magnitude <~ 2; one bf16 ulp there
# is 2**-7 ~ 7.8e-3; K1 keeps its probabilities fp32 where the plain paged
# version rounds them to bf16 before p @ v, and K2 and the plain flash
# version both round them, K2 before normalising, the plain one after)
KERNEL_TOL = 2e-2
# decode_step_paged K1 vs gather and prefill K2 vs plain, max |d logits|
# relative to the logits' spread. In bf16 the two paths round at different
# places (the gather oracle rounds its probabilities to bf16 before p @ v,
# K1 keeps fp32; K2 rounds its unnormalised ones) and 24 layers of bf16
# activations amplify a one-ulp difference; the same step in fp32 compute
# (the bf16 weights and pool are exact in fp32) leaves only the summation
# order, so its bound is tight.
STEP_REL_TOL = {"bfloat16": 0.25, "float32": 1e-3}
# the moestep phase's fp32 checks cut qwen2-moe to its first 8 of 24 layers
# (full width): an fp32 copy of all 24 would be 57 GB beside the 28.6 GB
# bf16 weights, more than the card's 80 GB; 8 layers are 20.7 GB
MOE_FP32_LAYERS = 8

# the train phase: stablelm-1.6b at full width and depth, the full
# preset's batch of 256 x 4096 cut to 8 x 2048 (one sequence per
# microbatch) so that the phase stays near 90 s; 2 steps (6, then 4, then
# 3, before; cut for the script's time: it took 984.0 s on an H100 whose
# host ran its host-bound phases slowly; 3 to 2 for the partitioned serve
# runs of train_mesh, ~18 s with their dry-run check, a step being ~7 s)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS = 8, 2048, 8, 2
# its checks: bf16 against fp32 compute at full width and 4 layers, |d
# loss| in nats and the grad norm's relative difference (measured on the
# H100: 2.6e-4 nats and 2.7e-4; the bounds are ~20x that)
TRAIN_CHECK_LAYERS = 4
TRAIN_BF16_TOL = {"loss": 5e-3, "grad_norm": 5e-3}
# the checkpoint branch on the card: the re-run step's loss against the
# first run's, relative (the same weights and batch; the embedding
# backward's atomics may change the last bits)
TRAIN_RERUN_REL = 1e-5

# the k3bwd phase: the backward kernel against autograd through the plain
# scan, max |kernel - plain| <= tol x max |plain| for each gradient. fp32:
# the sums over d (dB, dC: 512 channels), t (dA, d dt's share) and n run in
# other orders, and expf against torch.exp; bf16 x/B/C: dx, dB and dC are
# rounded to bf16 by both, where one ulp is 2**-8 of the magnitude
K3BWD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the training shape: one falcon-mamba-7b sequence a microbatch
K3BWD_SHAPE = (1, 2048, 8192, 16)
# the train_ssm and frontend phases: 2 steps (3 before, cut for the
# script's time) of TRAIN_BATCH x TRAIN_SEQ each, then a traced one;
# falcon-mamba-7b at full width cut to 16 of its 64 layers (its
# 7.27 B parameters' fp32 masters, gradients and moments, ~116 GB, do not
# fit the 80 GB card; 16 layers are ~2.2 B, ~36 GB)
TRAIN_SSM_STEPS = 2
FALCON_TRAIN_LAYERS = 16
# before them, in fp32 at full width, one batch's loss and gradients on
# the card against the CPU's: falcon-mamba at 4 layers, zamba2 at 14 (two
# groups of 6 and a 2-layer tail, so the shared block's gradient sums over
# groups; at 4 layers zamba2 holds no group); |d loss| relative, and per
# leaf max |d grad| over max |grad| (other summation orders: cuBLAS against
# the CPU's GEMMs, K3 and its backward against the plain scan)
SSM_CHECK = {"falcon-mamba-7b": 4, "zamba2-1.2b": 14}
SSM_CHECK_SHAPE = (2, 80)
SSM_CHECK_TOL = {"loss": 1e-5, "grad": 1e-3}
# the frontend phase: musicgen-large's 8 prompts of 64 tokens behind its
# 64 frames, 16 decode steps; the fp32 checks at full width and 4 layers
FRONTEND_PROMPT, FRONTEND_NEW, FRONTEND_CHECK_LAYERS = 64, 16, 4

PROMPT_LENS = (16, 24, 32, 57, 90, 128, 200, 300)
MAX_NEW = 32

# the nested phase's loop: x <- m @ x over d = 256
NESTED_D = 256
# the mesh phase: 2 gloo ranks on the one card; its fp32 check cuts
# stablelm-1.6b to 4 layers at full width (fp32 at full depth would be 6.6
# GB a rank, and the equality is exercised by every layer alike)
MESH_RANKS = 2
MESH_FP32_LAYERS = 4
MESH_PRESET = "full"
# the train_mesh phase: 2 gloo ranks on the one card, a (2, 1) mesh;
# stablelm-1.6b at full width in fp32 at 4 layers (one step of 2 x 2048,
# against the single-device step), in bf16 with remat (2 steps of 4 x
# 2048, two microbatches of one sequence a rank, the weight gather hoisted
# and not; 3 steps before, cut for the script's time: a run on an H100
# whose host ran the host-bound phases 15-30% slower took 1,144 s of the
# 1,200) and falcon-mamba-7b at full width cut to 4 of 64 layers (one
# bf16 step of 2 x 2048: K3 and its backward under the group); then the
# same fp32 stablelm step and falcon-mamba step on a (1, 2) mesh, whose
# step partitions its products over the model axis
TRAIN_MESH_RANKS = 2
TRAIN_MESH_PRESET = "full"
TRAIN_MESH_SEQ = 2048
TRAIN_MESH_STEPS = 2
TRAIN_MESH_FP32_LAYERS = 4
# bf16 cut from 24 to 8 layers: at 24 the phase took 175 s (14-28 s a
# step, each rank gathering and reducing 6.6 GB a step through the host),
# over its ~120 s budget; then to 4, as a run on an H100 with a slow host
# took 166.5 s in this phase at 8; then to 2 for the time of the (1, 2)
# runs (the phase took 124.5 s with them at 4)
TRAIN_MESH_BF16_LAYERS = 2
TRAIN_MESH_JOIN_S, TRAIN_MESH_OP_S = 900.0, 600.0
# falcon-mamba-7b's layers: the (1, 2) run's 4, the (2, 1) run's 2 (4
# before, cut for the script's time: its kernels are the (1, 2) run's)
TRAIN_MESH_FALCON_LAYERS = 4
TRAIN_MESH_FALCON_DP_LAYERS = 2
# qwen2-moe-a2.7b's layers in the (1, 2) runs (full width: 30 of its 60
# experts a rank): fp32 masters and moments of 2 layers are ~14 GB a rank,
# one device's fp32 step ~28 GB of state, all on the one card
TRAIN_MESH_MOE_LAYERS = 2
# zamba2-1.2b on (1, 2) at full width (D 2,048, dI 4,096, 64 SSD heads, N
# 64): one group of 6 Mamba2 layers and the shared block once, fp32; and
# internvl2-1b at full width (14 query heads, 2 KV heads) at 2 layers on
# (1, 4), attention whole on each rank, fp32, its 256 frames before the
# 2,048 tokens: 4 gloo ranks share the card in a session of their own
# (14 heads divide by the phase's 2)
TRAIN_MESH_ZAMBA2_LAYERS = 6
TRAIN_MESH_VLM_LAYERS = 2
TRAIN_MESH_VLM_RANKS = 4
# fp32, 2 ranks against one device: the metrics relative, the moments per
# leaf relative to its largest magnitude, the params in units of lr where
# AdamW's first step is well-conditioned and where a gradient lies within
# 100 eps of zero (there g / (|g| + eps) may differ by up to 2). Measured
# (PR 26 call 3): metrics 9.2e-7, m 9.6e-6, v 1.2e-5 (each rank's weight
# gradients sum 2048 tokens, then gloo sums the two, where cuBLAS sums
# 4096 in one GEMM), params 1.2e-4 lr and 0.32 lr
TRAIN_MESH_TOL = {"metric": 1e-5, "moment": 5e-5, "param_lr": 5e-2,
                  "ill_param_lr": 2.05}
# the partitioned serve steps in the same 2-rank session: stablelm-1.6b
# fp32 at 4 layers on (1, 2), 2 x 512-token prompts into a 1,024-position
# cache, then 8 greedy steps (each rank holds 512 positions of every KV
# head); bf16 at its 24 layers, 2 x 2,048 into 4,096 (K2 on each rank's
# 16 heads); falcon-mamba-7b fp32 at 4 of 64 layers on (1, 2) (K3 on each
# rank's 4,096 channels); stablelm fp32 at 4 layers with one row on
# (2, 1), the cache's positions over both ranks, its decode on weights
# resident whole (serve_tp_only: the step gathering the 0.8 GB fp32
# embedding through the host took ~3 s a step). fp32 tokens must be one
# device's and its logits within LOGIT_TOL (tests/test_torch_decode_step.py).
# The other runs take fewer steps for the script's time: the runs took
# 64.4 s with 8 steps each (bf16 ~0.6-1.1 s a step, falcon-mamba's
# in_proj exchange 0.5 s a step)
SERVE_MESH_FP32_LAYERS = 4
SERVE_MESH_FALCON_LAYERS = 4
SERVE_MESH_STEPS = 8
SERVE_MESH_SHORT_STEPS = 2
LOGIT_TOL = 1e-4
# rank 0's block of the fp32 cache against the plain path's (no
# hand-written kernel) on one device: max |d| <= STATE_TOL x max(1,
# max |plain|) per leaf (STATE_TOL as tests/test_torch_decode_step.py's)
STATE_TOL = 2e-5

# the prefix phase: the serve suite's continuous trace at the reference's
# non-quick shapes with 104 requests (over 100, so that the nearest-rank
# p99 is not the maximum; 128 until a run of the whole script on an H100
# with a slow host took 1,146.5 s of its 1,200), and its fp32 check of warm against cold
# tokens at full width and 4 layers
PREFIX_N_REQ = 104
PREFIX_FP32_LAYERS = 4
PREFIX_DIR = Path("build") / "prefix"

# the hybridstep phase's Mamba2 layer: SSD dual form against the
# recurrence, max |ssd - steps| <= SSD_REL_TOL x max |steps| on the layer's
# output and its final state (both fp32; the dual form sums exp(L_t - L_s)
# weighted products where the recurrence multiplies step by step)
SSD_REL_TOL = 1e-4

# K3 vs its plain version: max |kernel - plain| <= K3_REL_TOL x max(1,
# max |plain|), on y and the final state. Both run the fp32 recurrence step
# by step; they differ in expf against torch.exp, in FMA contraction and in
# the order of the 16-term sum over the state
K3_REL_TOL = 1e-5

# the LSDNN phase: the HPEC challenge's 1024-neuron, 120-layer network on
# its 60,000 input rows (bench/fig13_lsdnn.py), 2 chained passes, 8 layers
# per captured DeviceFlow op
LSDNN_ROWS = 60000
LSDNN_PASSES = 2
LSDNN_BLOCK = 8
LSDNN_CAP = 32.0
F32, BF16 = torch.float32, torch.bfloat16
# K4 vs its plain version, max abs error: fp32 1e-4 x cap (the same exact
# fp32 products, summed in another order); bf16 0.3 as the reference's own
# test (one bf16 ulp of an output near the cap is 0.125)
K4_TOL = {F32: 1e-4 * LSDNN_CAP, BF16: 0.3}
# K4's time taken apart: the kernel rebuilt from its source with parts of
# its work cut out (their results are wrong; they are timed, never used),
# each (anchor in csrc/lsdnn_layer.cu, replacement)
_Y_COPY = ("      copy1<T>(ad + 8 * i * kAS + 32 * j, ok ? yr + 8 * i : y, "
           "ok);\n", "")
_W_COPY = ("      copy4<T>(bd + 32 * i, ok ? ws + 32 * i : w, ok);\n", "")
_BARRIER = ("    __syncthreads();  // everyone's have; step - 1's stage is free "
            "to refill\n", "")
# K1's and K3's time taken apart in the same way (timed in CUDA graphs; the
# ex2 build's exponential is approximate, so it shows what a restated
# tolerance would buy)
_K1_TAB_STAGE = ("  for (int j = threadIdx.x; j < min(mb, kTabCap); j += kThreads)\n"
                 "    s_tab[j] = tab[j];\n", "")
_K1_TAB_BARRIER = ("  __syncthreads();  // s_tab is filled (the only barrier "
                   "before the merge)\n", "")
K1_ABLATIONS = {
    "k1_1_stage": [("constexpr int kStages = 3;",
                    "constexpr int kStages = 1;")],
    "k1_2_stages": [("constexpr int kStages = 3;",
                     "constexpr int kStages = 2;")],
    "k1_table_ldg": [_K1_TAB_STAGE, _K1_TAB_BARRIER, (
        "at.j < kTabCap ? s_tab[at.j] : __ldg(tab + at.j)",
        "__ldg(tab + at.j)")],
}
_K3_AHEAD = ("    if (more) load(t0 + kChunk);   // in flight during this "
             "chunk's steps\n")
_K3_STAGE = "    if (more) stage(st ^ 1);\n"
K3_ABLATIONS = {
    "k3_2_states": [("constexpr int kStates = 4;",
                     "constexpr int kStates = 2;")],
    "k3_group8": [("constexpr int kGroup = 16;", "constexpr int kGroup = 8;")],
    "k3_loads_not_ahead": [(_K3_AHEAD, ""), (_K3_STAGE, (
        "    if (more) {\n      load(t0 + kChunk);\n      stage(st ^ 1);\n"
        "    }\n"))],
    "k3_ex2_approx": [
        ("// raw bits of one value of x, B or C", (
            "__device__ __forceinline__ float ex2f_approx(float x) {\n"
            "  float y;\n  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : "
            "\"f\"(x));\n  return y;\n}\n\n"
            "// raw bits of one value of x, B or C")),
        ("          ea[u][k] = expf(v.x * a_n[k]);",
         "          ea[u][k] = ex2f_approx(v.x * a_n[k]);"),
        ("    a_n[k] = live ? A[(size_t)d * N + n0 + k] : 0.f;",
         "    a_n[k] = live ? A[(size_t)d * N + n0 + k] * "
         "1.44269504088896341f : 0.f;")],
}
# K3's backward taken apart the same way (timed in CUDA graphs beside it,
# with --k3bwd-ablations):
# without its d-sum tile (the products neither written nor summed), with B
# and C (then a_t) taken from registers instead of shared memory, and
# without the first half's second recompute
_BWD_TILE_READ = "        if (i % kTile == 0) {\n"
_BWD_TILE_W1 = ("        *reinterpret_cast<float4*>(row + ((kStates * r) ^ "
                "sw)) =\n")
_BWD_TILE_W2 = ("        *reinterpret_cast<float4*>(row + ((kMaxN + kStates * "
                "r) ^ sw)) =\n")
K3BWD_ABLATIONS = {
    "no_dsum_tile": [(_BWD_TILE_READ, "        if (false) {\n"),
                     (_BWD_TILE_W1, "        if (false)" + _BWD_TILE_W1[7:]),
                     (_BWD_TILE_W2, "        if (false)" + _BWD_TILE_W2[7:])],
    "no_bc_loads": [(
        "        unpack4(*reinterpret_cast<const float4*>(&sm.b[u][n0]), bb);\n"
        "        unpack4(*reinterpret_cast<const float4*>(&sm.c[u][n0]), cc);\n",
        "        unpack4(make_float4(a_n[1], a_n[2], a_n[3], a_n[0]), bb);\n"
        "        unpack4(make_float4(a_n[2], a_n[3], a_n[0], a_n[1]), cc);\n")],
    "no_a_loads": [("        unpack4(sm.a[u][tid], aa);\n",
                    "        unpack4(make_float4(a_n[0], a_n[1], a_n[2], "
                    "a_n[3]), aa);\n")],
    "no_second_recompute": [("      if (half == 0) {\n",
                             "      if (false) {\n")],
}
# SASS instructions counted in K1 and K3 (static counts over each entry)
K1_SASS = ("ALL", "LDG", "SHFL", "MUFU", "FFMA", "BAR", "LDS", "STS")
K3_SASS = ("ALL", "LDG", "SHFL", "MUFU", "FFMA", "FMUL", "BAR", "LDS", "STG")
K4_ABLATIONS = {"no_y_copies": [_Y_COPY],
                "no_copies": [_Y_COPY, _W_COPY],
                "no_copies_no_barrier": [_Y_COPY, _W_COPY, _BARRIER]}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 20, replays: int = 10) -> float:
    """Mean device time per call with the host out of the loop: ``n`` calls
    captured into one CUDA graph, replayed ``replays`` times, CUDA events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def host_us(fn, iters: int = 50) -> float:
    """Host time per call in us: ``iters`` calls enqueued back to back on
    the host clock, the device drained before and after (the wrapper's
    Python, its checks, the allocation of its output and the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / iters


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def ptxas_of(kernel: str, log_text=None):
    """ptxas's registers / shared memory / spill lines for each compiled
    entry whose name holds ``kernel``, from the build log (or
    ``log_text``, another build's)."""
    from repro_torch.kernels._build import build_info
    entries, cur = {}, None
    text = build_info()["ptxas"] if log_text is None else log_text
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            entries[cur] = []
        elif cur and ("spill" in ln or "Used" in ln):
            entries[cur].append(ln.split(":", 1)[-1].strip() if "Used" in ln
                                else ln.strip())
    names = [n for n in entries if kernel in n]
    return [f"{d}: {'; '.join(entries[n])}"
            for n, d in zip(names, _demangle(names))]


def sass_counts(kernel: str, ops=("HMMA", "LDSM", "LDGSTS", "FFMA")):
    """Count SASS instructions (``cuobjdump -sass`` of the built library)
    in each function whose name holds ``kernel``; ``ALL`` counts every
    instruction."""
    from repro_torch.kernels._build import _nvcc, build_info
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", build_info()["path"]],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for ln in text.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ")[1].strip()
            cur = name if kernel in name else None
            if cur:
                counts[cur] = dict.fromkeys(ops, 0)
        elif cur and ln.lstrip().startswith("/*") and ";" in ln:
            if "ALL" in ops:
                counts[cur]["ALL"] += 1
            for op in ops:
                if f" {op}" in ln:
                    counts[cur][op] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


def kernel_report(prefix: str, kernel: str, flops: float, ms: float,
                  b_ms: float, lib_ms, sass, dev_ms=None, lib_dev_ms=None,
                  host=None) -> None:
    """ptxas and SASS lines, then rate, % of the bound and kernel / library
    of the eager time and, where given, of the device time in a CUDA graph
    (``dev_ms``, ``lib_dev_ms``), and the wrapper's host time per call
    (``host``, us)."""
    for ln in ptxas_of(kernel):
        log(f"{prefix} ptxas {ln}")
    for name, c in sass.items():
        log(f"{prefix} sass {name}: {c}")
    for what, t, lib in (("eager", ms, lib_ms), ("device", dev_ms,
                                                  lib_dev_ms)):
        if t is None:
            continue
        ratio = f"{t / lib:.3f}" if lib else "n/a"
        log(f"{prefix} {what}: {t:.5f} ms, {flops / t / 1e9:.3f} TFLOP/s, "
            f"{100 * b_ms / t:.1f}% of the bound, kernel / library {ratio}")
    if host is not None:
        log(f"{prefix} wrapper host time per call {host:.2f} us (eager "
            f"calls are bound by the larger of host and device time)")


# ------------------------------------------------------------------ phase 1
def phase_card() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    return smi


# ------------------------------------------------------------------ phase 2
def phase_build() -> None:
    from repro_torch.kernels._build import build_info, ensure_built
    ensure_built()
    info = build_info()
    regs = [ln.strip() for ln in info["ptxas"].splitlines()
            if "registers" in ln]
    log(f"[build] {info['seconds']:.2f}s (compiled={info['built']}) -> "
        f"{info['path']}; ptxas: {sorted(set(regs))}")


# ------------------------------------------------------------------ phase 3
def _paged_case(B, H, KV, hd, bs, N, mb, lengths, dev, seed):
    """bf16 pool and disjoint block tables covering ``lengths``; a negative
    length parks the row on the sink block (table of zeros, pos 0)."""
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev).bfloat16()
    pool = torch.randn((2, N, KV, bs, hd), generator=g,
                       device=dev).bfloat16()
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(np.arange(1, N)))
    tables = np.zeros((B, mb), np.int32)
    for b, ln in enumerate(lengths):
        if ln >= 0:
            for j in range(ln // bs + 1):
                tables[b, j] = free.pop()
    ln = np.maximum(np.asarray(lengths, np.int32), 0)
    return (q, pool, torch.from_numpy(tables).to(dev),
            torch.from_numpy(ln).to(dev))


def phase_kernels(dev, other=None):
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         paged_attention_ref)
    ablations = _build_ablations("paged_attention.cu", K1_ABLATIONS, other)
    # (they build while the checks run)
    report = {}
    # ---- K1 at the serve path's shapes: one layer's pool (2, 128, KV, 16,
    # 64), tables (8, 32); ragged lengths with a sink row (-1) and
    # positions where bs does not divide pos + 1
    bs, N, mb = 16, 128, 32
    lengths = [-1, 15, 16, 47, 100, 200, 331, 255]
    errs = []
    for (H, KV) in ((32, 32), (32, 8)):
        q, pool, tables, ln = _paged_case(8, H, KV, 64, bs, N, mb, lengths,
                                          dev, seed=H + KV)
        out = paged_mod.paged_attention_cuda(q, pool, tables, ln)
        ref = paged_attention_ref(q, pool, tables, ln)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.isfinite(out.float()).all().item()
        log(f"[kernels] K1 paged_attention B=8 H={H} KV={KV} hd=64 bs={bs}"
            f" lengths={lengths}: max|kernel-plain|={err:.3e} "
            f"(tol {KERNEL_TOL})")
        if not ok or err > KERNEL_TOL:
            raise SystemExit(f"K1 disagrees with its plain version: {err}")
        errs.append(err)
    # timing at the MHA serve shape (stablelm: H = KV = 32)
    q, pool, tables, ln = _paged_case(8, 32, 32, 64, bs, N, mb, lengths,
                                      dev, seed=64)
    t = _k1_times(q, pool, tables, ln)
    ms, lib_ms, b_ms = t["ms"], t["lib_ms"], t["bound_ms"]
    report["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:56",
        max_abs_err=max(errs), ms=ms, plain_ms=t["plain_ms"], bound_ms=b_ms,
        bound_by=t["bound_by"], library_ms=lib_ms)
    log(f"[kernels] K1 timing B=8 H=KV=32: {_k1_line(t)}")
    host = host_us(lambda: paged_mod.paged_attention_cuda(q, pool, tables, ln))
    kernel_report("[kernels] K1", "paged_attention", t["flops"], ms, b_ms,
                  lib_ms, sass_counts("paged_attention", K1_SASS),
                  t["dev_ms"], t["lib_dev_ms"], host)
    out = torch.empty_like(q)
    cut = _time_ablations(
        ablations, "repro_paged_attention",
        (1, q.data_ptr(), pool.data_ptr(), tables.data_ptr(), ln.data_ptr(),
         out.data_ptr(), 8, 32, 32, N, bs, 64, mb, 64 ** -0.5),
        lambda: paged_mod.paged_attention_cuda(q, pool, tables, ln),
        "repro_paged_attention_init", timer=graph_ms)
    log(f"[kernels] K1 ablation (same inputs, one part of the design "
        f"changed; device time in CUDA graphs, in turns): {_turns(cut)}")

    # ---- K2 at the window-0 prefill shape (max_admit=4, C0=128, H=32,
    # hd=64), plus a ragged S and a GQA case
    errs = []
    g = torch.Generator(dev).manual_seed(1)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    cases = [(4, 128, 32, 32, True), (4, 100, 32, 32, True),
             (4, 128, 32, 8, True), (2, 77, 32, 32, False)]
    main = None
    for (B, S, H, KV, causal) in cases:
        q, k, v = mk(B, S, H, 64), mk(B, S, KV, 64), mk(B, S, KV, 64)
        out = flash_mod.flash_attention_cuda(q, k, v, causal=causal)
        ref = flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        log(f"[kernels] K2 flash_attention B={B} S=T={S} H={H} KV={KV} "
            f"hd=64 causal={causal}: max|kernel-plain|={err:.3e} "
            f"(tol {KERNEL_TOL})")
        if not torch.isfinite(out.float()).all().item() or err > KERNEL_TOL:
            raise SystemExit(f"K2 disagrees with its plain version: {err}")
        errs.append(err)
        if main is None:
            main = (q, k, v)
    t = _k2_times(*main)
    sass = sass_counts("flash_attention_bf16")
    if not sass or not all(c["HMMA"] and c["LDGSTS"] for c in sass.values()):
        raise SystemExit(f"K2's bf16 SASS lacks HMMA or LDGSTS: {sass}")
    report["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:39",
        max_abs_err=max(errs), ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["lib_ms"])
    log(f"[kernels] K2 timing B=4 S=T=128 H=32 causal: {_k2_line(t)}")
    kernel_report("[kernels] K2", "flash_attention", t["flops"], t["ms"],
                  t["bound_ms"], t["lib_ms"], sass)
    return report


def _k1_times(q, pool, tables, ln) -> dict:
    """K1 timed beside its plain version and SDPA over the equivalent
    CONTIGUOUS cache (the gather that builds it is done once here and
    excluded from the time), eagerly and as device time in a CUDA graph,
    and its bound for these inputs: the table entries of the active pages
    and, of those pages, only the keys that attend (keys 0..pos; the rest
    are zero-filled, not read)."""
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels.ref import paged_attention_ref
    B, H, hd = q.shape
    KV, bs = pool.shape[2], pool.shape[3]
    mb = tables.shape[1]

    def kernel():
        return paged_mod.paged_attention_cuda(q, pool, tables, ln)
    T = mb * bs
    pages = pool[:, tables.long()]                # (2, B, mb, KV, bs, hd)
    kc, vc = pages.permute(0, 1, 3, 2, 4, 5).reshape(2, B, KV, T, hd)
    mask = (torch.arange(T, device=q.device)[None, :]
            <= ln.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                              enable_gqa=H != KV)
    nb = (ln.long() // bs + 1).clamp(max=mb)
    keys = int((ln.long() + 1).clamp(max=mb * bs).sum())
    nbytes = 2 * q.numel() * q.element_size() \
        + keys * KV * hd * 2 * pool.element_size() + int(nb.sum()) * 4 + B * 4
    flops = 4.0 * keys * H * hd
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(ms=time_ms(kernel),
                plain_ms=time_ms(lambda: paged_attention_ref(q, pool, tables,
                                                             ln), iters=10),
                lib_ms=time_ms(sdpa), dev_ms=graph_ms(kernel),
                lib_dev_ms=graph_ms(sdpa), bound_ms=b_ms, bound_by=b_by,
                nbytes=nbytes, flops=flops)


def _k1_line(t) -> str:
    return (f"kernel {t['ms']:.4f} ms | plain {t['plain_ms']:.4f} ms | SDPA "
            f"on contiguous cache {t['lib_ms']:.4f} ms (gather excluded) | "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}; {t['nbytes']} B,"
            f" {t['flops']:.3e} flop) | device time in a CUDA graph: kernel "
            f"{t['dev_ms']:.5f} ms, SDPA {t['lib_dev_ms']:.5f} ms")


def _k2_times(q, k, v) -> dict:
    """K2 (causal) timed beside its plain version and SDPA(is_causal),
    eagerly and as device time in a CUDA graph, and its bound: q, k, v read
    and the output written once; the causal half of the products at the
    bf16 tensor rate (the fp32 rate for fp32 inputs)."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels.ref import flash_attention_ref
    B, S, H, hd = q.shape
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def kernel():
        return flash_mod.flash_attention_cuda(q, k, v)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=H != k.shape[2])
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4.0 * B * H * hd * (S * (S + 1) // 2)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S
                          if q.dtype == BF16 else FP32_FLOPS_PER_S)
    return dict(ms=time_ms(kernel),
                plain_ms=time_ms(lambda: flash_attention_ref(q, k, v),
                                 iters=10),
                lib_ms=time_ms(sdpa), dev_ms=graph_ms(kernel),
                lib_dev_ms=graph_ms(sdpa), bound_ms=b_ms, bound_by=b_by,
                nbytes=nbytes, flops=flops)


def _k2_line(t) -> str:
    return (f"kernel {t['ms']:.4f} ms | plain {t['plain_ms']:.4f} ms | "
            f"SDPA(is_causal) {t['lib_ms']:.4f} ms | bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}; {t['nbytes']} B, "
            f"{t['flops']:.3e} flop) | device time in a CUDA graph: kernel "
            f"{t['dev_ms']:.5f} ms, SDPA {t['lib_dev_ms']:.5f} ms")


# ------------------------------------------------- the captured chunk
def _cycle_split(obs) -> str:
    """The mean decode cycle and its split, ms, from an engine's registry."""
    m = obs.metrics
    parts = {k: m.get(f"engine.{k}_s").summary()
             for k in ("cycle", "dispatch", "chunk_sync", "book", "gap")}
    return f"{parts['cycle']['count']} decode cycles, mean ms: " + ", ".join(
        f"{k} {1e3 * v['mean']:.3f}" for k, v in parts.items())


def _chunk_state(eng):
    """The tensors a decode chunk writes besides its carry and output: the
    paged pool, or the slot-state pool's leaves."""
    if eng.paged:
        return [eng._pkv]
    return [t for _, t in _pool_leaves(eng._sstate)]


def _freeze_chunk(eng, rows: int) -> dict:
    """Wrap ``eng``'s chunk program (an instance attribute; ``del
    eng._chunk.run`` unwraps it) so that the first chunk with at least
    ``rows`` active rows has its inputs copied before it runs: ``state``
    (and, paged, ``pool``, ``tables``), ``carry`` (3, B)."""
    frozen = {}
    chunk = eng._chunk
    real = chunk.run

    def spy():
        if "state" not in frozen and int((chunk.carry[2] > 0).sum()) >= rows:
            frozen["state"] = [t.clone() for t in _chunk_state(eng)]
            frozen["carry"] = chunk.carry.clone()
            if eng.paged:
                frozen["pool"] = frozen["state"][0]
                frozen["tables"] = eng._tables_dev.clone()
        real()

    chunk.run = spy
    return frozen


def _restore_chunk(eng, frozen) -> None:
    """Put the frozen chunk inputs back into the engine's own tensors."""
    for t, f in zip(_chunk_state(eng), frozen["state"]):
        t.copy_(f)
    if eng.paged:
        eng._tables_dev.copy_(frozen["tables"])
    eng._chunk.carry.copy_(frozen["carry"])


def _rest(eng) -> None:
    """Wait until the engine's pipeline has no run in flight."""
    t0 = time.perf_counter()
    while not (eng._pipeline is None or eng._pipeline.idle()):
        if time.perf_counter() - t0 > 60:
            raise SystemExit("the engine did not come to rest in 60 s")
        time.sleep(0.005)


def _graph_vs_eager(eng, frozen, tag: str) -> None:
    """The frozen chunk through the engine's captured graph (one replay)
    and through the same body run eagerly, on the engine's own tensors:
    tokens and advanced carry must be equal, and the state they write is
    compared (paged: the sink block, garbage by contract, masked out)."""
    chunk = eng._chunk
    if chunk.graph is None:
        raise SystemExit(f"[{tag}] the engine did not capture its chunk")
    res = {}
    with torch.inference_mode():
        for name, fn in (("graph", chunk.run), ("eager", chunk._body)):
            _restore_chunk(eng, frozen)
            fn()
            torch.cuda.synchronize()
            st = [t.clone() for t in _chunk_state(eng)]
            if eng.paged:
                st[0][:, :, 0] = 0
            res[name] = (chunk.out.clone(), st)
    (g_out, g_st), (e_out, e_st) = res["graph"], res["eager"]
    same = torch.equal(g_out, e_out)
    state_eq = all(torch.equal(a, b) for a, b in zip(g_st, e_st))
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(g_st, e_st))
    active = int((frozen["carry"][2] > 0).sum())
    log(f"[{tag}] captured chunk vs eager on a frozen mid-run chunk "
        f"({active} active rows, n={chunk.n}, L={eng.cfg.num_layers}, "
        f"{eng.cfg.compute_dtype}): tokens and carry equal {same}, written "
        f"state equal {state_eq} (max |d| {diff:.3e})")
    if not same:
        bad = (g_out != e_out).any(1).nonzero()[:, 0].tolist()
        raise SystemExit(f"[{tag}] graph tokens differ from eager on rows "
                         f"{bad}")


def _chunk_device_ms(eng, frozen, tag: str, card: str, reps: int = 3
                     ) -> dict:
    """The frozen chunk as one replay and eagerly, medians of ``reps``:
    the host's time in the call (enqueue), the CUDA-event time from before
    the call to after it (for the eager chunk the device waits on the
    host's enqueue, so this is its wall on the device) and the device busy
    time (``torch.profiler``'s kernel durations summed, one call); and the
    host time of a replay enqueued right behind another (the graph launch
    while the device is busy, as the async engine issues it)."""
    chunk = eng._chunk
    out = {}
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        for name, fn in (("graph", chunk.run), ("eager", chunk._body)):
            dev_ms, host_ms = [], []
            for _ in range(reps):
                _restore_chunk(eng, frozen)
                torch.cuda.synchronize()
                e0.record()
                t0 = time.perf_counter()
                fn()
                host_ms.append(1e3 * (time.perf_counter() - t0))
                e1.record()
                torch.cuda.synchronize()
                dev_ms.append(e0.elapsed_time(e1))
            _restore_chunk(eng, frozen)
            busy, launches, _ = _profile_rows(fn)
            out[name] = {"event_ms": float(np.median(dev_ms)),
                         "host_ms": float(np.median(host_ms)),
                         "busy_ms": busy, "kernels": launches}
        behind = []
        for _ in range(reps):
            _restore_chunk(eng, frozen)
            torch.cuda.synchronize()
            chunk.run()
            t0 = time.perf_counter()
            chunk.run()
            behind.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
        out["graph"]["host_behind_ms"] = float(np.median(behind))
    g, e = out["graph"], out["eager"]
    log(f"[{tag}] decode chunk (B={chunk.carry.shape[1]}, n={chunk.n}, "
        f"L={eng.cfg.num_layers}, {eng.cfg.compute_dtype}): one replay "
        f"{g['event_ms']:.3f} ms on the device (busy {g['busy_ms']:.3f} ms, "
        f"{g['kernels']} kernels), host {g['host_ms']:.3f} ms, "
        f"{g['host_behind_ms']:.3f} ms behind a running replay; eager "
        f"{e['event_ms']:.3f} ms on the device (busy {e['busy_ms']:.3f} ms, "
        f"{e['kernels']} kernels), host enqueue {e['host_ms']:.3f} ms; on "
        f"{card}")
    return out


# ------------------------------------------------------------------ phase 4
def phase_serve(dev, arch: str = "stablelm-1.6b", tag: str = "serve",
                card: str = ""):
    """A paged arch at full width and depth through the engine: stablelm
    (dense) or qwen2-moe (``tag`` "moe"; 60 experts top-4 and shared
    experts in each layer's FFN); ``card`` is printed beside the serve
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.obs import Observability
    from repro_torch.params import init_params, param_bytes
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)                        # full width and depth
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    wbytes = param_bytes(params)
    ffn = (f"E={cfg.num_experts} top-{cfg.num_experts_per_tok} "
           f"F={cfg.moe_d_ff} shared={cfg.shared_expert_d_ff}") if cfg.moe \
        else f"F={cfg.d_ff}"
    log(f"[{tag}] {cfg.name}: L={cfg.num_layers} D={cfg.d_model} "
        f"H={cfg.num_heads} KV={cfg.num_kv_heads} hd={cfg.hd} "
        f"{ffn} V={cfg.vocab_size}; weights {wbytes / 1e9:.3f} GB "
        f"(matrices bf16) in {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    t0 = time.perf_counter()
    obs = Observability()
    eng = ServeEngine(cfg, params, decode_chunk=8, max_batch=8,
                      kv_blocks=128, block_size=16, device=dev, obs=obs)
    log(f"[{tag}] engine built with the decode chunk captured in "
        f"{time.perf_counter() - t0:.2f}s: {eng._chunk.captured_launches} "
        f"launches recorded per replay")
    # freeze one mid-run decode chunk's inputs for phase 5 and the graph
    # against eager check (copied before the chunk writes to the pool)
    frozen = _freeze_chunk(eng, len(PROMPT_LENS) // 2)
    try:
        mem0 = torch.cuda.memory_allocated()
        pool_bytes = eng._pkv.numel() * eng._pkv.element_size()
        log(f"[{tag}] engine: pool {tuple(eng._pkv.shape)} "
            f"{pool_bytes / 1e6:.1f} MB, paged_impl="
            f"{eng.paged_impl}, "
            f"prefill_chunk={eng.prefill_chunk}")
        # warm-up request (cuBLAS handles, allocator), outside the counts
        eng.result(eng.submit(prompts[0][:8], max_new=2))
        torch.cuda.synchronize()
        stats0 = dict(eng.stats)
        obs.reset()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = []
        for p in prompts:
            reqs.append(eng.submit(p, max_new=MAX_NEW))
            time.sleep(0.02)
        outs = [eng.result(r, timeout=600.0) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        del eng._chunk.run          # the spy: back to the class's run
        if "pool" not in frozen:
            raise SystemExit("no decode chunk with a full batch was seen")
        # on the resting engine: close() frees the captured graph
        _rest(eng)
        _graph_vs_eager(eng, frozen, tag)
        chunk_ms = _chunk_device_ms(eng, frozen, tag, card)
    finally:
        eng._chunk.__dict__.pop("run", None)
        eng.close()
    stats = {k: v - stats0.get(k, 0) for k, v in eng.stats.items()}
    for p, o in zip(prompts, outs):
        if o.shape != (MAX_NEW,) or not ((o >= 0) & (o < cfg.vocab_size)
                                         ).all():
            raise SystemExit(f"bad output for prompt len {len(p)}: {o}")
    if eng._pool.num_free != eng._pool.num_blocks - 1:
        raise SystemExit(f"blocks leaked: {eng._pool.num_free} free of "
                         f"{eng._pool.num_blocks - 1}")
    steps = stats["decode_cycles"] * eng.decode_chunk
    L = cfg.num_layers
    if counts["paged_attention"] < L * steps or steps == 0:
        raise SystemExit(f"K1 launches {counts['paged_attention']} < "
                         f"{L} x {steps} decode steps")
    if counts["flash_attention"] < L * stats["prefills"] \
            or stats["prefills"] == 0:
        raise SystemExit(f"K2 launches {counts['flash_attention']} < "
                         f"{L} x {stats['prefills']} window-0 prefills")
    ttft = sorted(r.ttft for r in reqs)
    tok = len(prompts) * MAX_NEW
    log(f"[{tag}] {len(prompts)} requests, prompts {list(PROMPT_LENS)}, "
        f"max_new {MAX_NEW}: {tok} tokens in {wall:.3f}s = "
        f"{tok / wall:.1f} tok/s | TTFT p50 {ttft[len(ttft) // 2]:.4f}s "
        f"max {ttft[-1]:.4f}s on {card} | stats {stats}")
    log(f"[{tag}] launches {counts} over {steps} decode steps and "
        f"{stats['prefills']} window-0 prefills; weights "
        f"{wbytes / 1e9:.3f} GB, pool {pool_bytes / 1e6:.1f} MB, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(resident before run {mem0 / 1e9:.2f} GB); all "
        f"{eng._pool.num_blocks - 1} non-sink blocks free")
    log(f"[{tag}] sample: {outs[0][:16].tolist()}")
    log(f"[{tag}] {_cycle_split(obs)}")
    if counts["paged_attention"] != L * steps:
        raise SystemExit(f"K1 launches {counts['paged_attention']} != {L} x "
                         f"{steps}: every decode step is one replay's")
    del eng
    gc.collect()
    return cfg, params, prompts, frozen, counts, chunk_ms


# ------------------------------------------------------------------ phase 5
def _fp32_params(params, layers=None):
    """A copy of a param dict with every leaf in fp32 (the fp32-compute
    checks: bf16 weights are exact in fp32); ``layers`` keeps only the
    first that many layers of the stacks (a cut of depth, never of
    width)."""
    return {k: ({kk: vv[:layers].float() for kk, vv in v.items()}
                if isinstance(v, dict) else v.float())
            for k, v in params.items()}


def _compare(name, a, b, tol, tag="steps"):
    """Logit agreement of two (B, V) fp32 tensors: relative max error, top-1
    agreement, and at the first disagreeing row its top-2 margin."""
    spread = b.std().item()
    rel = (a - b).abs().max().item() / spread
    ta, tb = a.argmax(-1), b.argmax(-1)
    agree = (ta == tb).float().mean().item()
    msg = f"[{tag}] {name}: max|d|/std = {rel:.3e} (tol {tol}), " \
          f"top-1 agreement {agree:.3f} over {len(ta)} rows"
    bad = (ta != tb).nonzero()
    if len(bad):
        r = int(bad[0])
        top2 = b[r].topk(2).values
        msg += f"; first flip row {r}, top-2 margin " \
               f"{(top2[0] - top2[1]).item():.4e}"
    log(msg)
    if not (rel <= tol and torch.isfinite(a).all()):
        raise SystemExit(f"{name}: logits disagree ({rel} > {tol})")


def _window0(prompts, dev):
    """The window-0 prefill shape: max_admit=4 rows of C0=128 tokens."""
    return torch.from_numpy(np.stack([np.resize(p, 128)
                                      for p in prompts[4:]])).to(dev)


def phase_steps(cfg, params, prompts, frozen, dev, tag="steps",
                fp32_layers=None):
    """One decode step on the frozen pool with K1 and with the gather
    oracle, and one window-0 prefill with K2 and with the plain path,
    compared in bf16 at full depth and in fp32 compute at full width and
    ``fp32_layers`` layers (None: full depth; a layer's KV depends only on
    the layers below it, so the pool's first layers serve the cut model)."""
    import dataclasses

    from repro_torch.models import lm
    ln, last, rem = frozen["carry"]
    active = rem > 0
    rows = active.nonzero()[:, 0]
    toks = _window0(prompts, dev)
    L32 = fp32_layers or cfg.num_layers
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                num_layers=L32)
    with torch.inference_mode():
        for dt, c in (("bfloat16", cfg), ("float32", cfg32)):
            p = params if dt == "bfloat16" else _fp32_params(params,
                                                             fp32_layers)
            pool = frozen["pool"][:c.num_layers].to(getattr(torch, dt))
            out = {}
            for impl in ("kernel", "gather"):
                out[impl], _ = lm.decode_step_paged(
                    c, p, pool.clone(), frozen["tables"], ln, last, active,
                    impl=impl)
            what = f"{dt} L={c.num_layers}"
            _compare(f"{what} decode_step_paged K1 vs gather",
                     out["kernel"][rows], out["gather"][rows],
                     STEP_REL_TOL[dt], tag)
            lf, cf = lm.prefill(c, p, toks, impl="flash")
            lp, cp = lm.prefill(c, p, toks, impl="chunked")
            _compare(f"{what} prefill K2 vs plain", lf, lp, STEP_REL_TOL[dt],
                     tag)
            kd = (cf["k"].float() - cp["k"].float()).abs().max().item()
            log(f"[{tag}] {what} prefill cache k max|flash-plain| = "
                f"{kd:.3e}")
            del p, pool, out, cf, cp


# ------------------------------------------------------------------ phase 6
def _rel(a, b) -> float:
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def phase_k3(dev, other=None):
    from repro_torch.kernels import mamba_scan as scan_mod
    from repro_torch.kernels.ref import mamba_scan_ref
    ablations = _build_ablations("mamba_scan.cu", K3_ABLATIONS, other)
    # (they build while the checks run)
    g = torch.Generator(dev).manual_seed(3)

    def inputs(B, S, dI, N, dtype, h0):
        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        dt = F.softplus(randn(B, S, dI)) * 0.1
        return (dt, randn(B, S, dI).to(dtype), randn(B, S, N).to(dtype),
                randn(B, S, N).to(dtype), -torch.exp(randn(dI, N) * 0.5),
                randn(B, dI, N) if h0 else None)

    # the SSM prefill path's shapes (B=1, dI=8192, N=16, bf16 x/B/C, fp32
    # dt) at three prompt lengths, then a ragged dI (not a multiple of the
    # 16-channel block) with an odd S, B=4, fp32 inputs and an initial state
    cases = [("prefill", 1, 16, 8192, 16, BF16, False),
             ("prefill", 1, 57, 8192, 16, BF16, False),
             ("prefill", 1, 300, 8192, 16, BF16, False),
             ("ragged dI, odd S", 1, 33, 1000, 16, BF16, False),
             ("B=4", 4, 300, 8192, 16, BF16, False),
             ("fp32 inputs", 1, 300, 8192, 16, F32, False),
             ("initial state", 2, 70, 8192, 16, BF16, True)]
    errs = []
    for what, B, S, dI, N, dtype, h0 in cases:
        dt, x, Bc, Cc, A, init = inputs(B, S, dI, N, dtype, h0)
        y, hT = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, h0=init)
        yr, hr = mamba_scan_ref(dt, A, Bc, Cc, x, h0=init)
        torch.cuda.synchronize()
        ey, eh = _rel(y, yr), _rel(hT, hr)
        ok = torch.isfinite(y).all().item() and torch.isfinite(hT).all().item()
        log(f"[k3] {what} B={B} S={S} dI={dI} N={N} {str(dtype)[6:]}: "
            f"max|kernel-plain|/max(1,|plain|) y {ey:.3e} hT {eh:.3e} (tol "
            f"{K3_REL_TOL}); max|y| {yr.abs().max().item():.4g}")
        if not ok or max(ey, eh) > K3_REL_TOL:
            raise SystemExit(f"K3 disagrees with its plain version: {ey}, "
                             f"{eh}")
        errs.append((y - yr).abs().max().item())
    # timing at the path's longest prompt: B=1, S=300
    dt, x, Bc, Cc, A, _ = inputs(1, 300, 8192, 16, BF16, False)
    B, S, dI = x.shape
    N = A.shape[1]
    ms = time_ms(lambda: scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A))
    plain_ms = time_ms(lambda: mamba_scan_ref(dt, A, Bc, Cc, x), iters=5,
                       warmup=1)
    nbytes = 4 * B * S * dI + 2 * B * S * dI + 2 * 2 * B * S * N \
        + 4 * dI * N + 4 * B * S * dI + 4 * B * dI * N
    elems = B * S * dI * N
    # per (b, t, d, n): exp argument, FMA (2), dx * B, h * C, one add of
    # the sum over n; per (b, t, d): dt * x
    flops = 6.0 * elems + B * S * dI
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = elems / SFU_EXP_PER_S * 1e3
    t_fma = flops / FP32_FLOPS_PER_S * 1e3
    b_ms = max(t_b, t_exp, t_fma)
    b_by = "bytes" if t_b >= max(t_exp, t_fma) else "operations"
    dev_ms = graph_ms(lambda: scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A))
    log(f"[k3] timing B=1 S=300 dI=8192 N=16 bf16: kernel {ms:.4f} ms | "
        f"plain {plain_ms:.4f} ms | no library call computes a selective "
        f"scan | bound {b_ms:.5f} ms ({b_by}: bytes {t_b:.5f} ms for "
        f"{nbytes} B, exps {t_exp:.5f} ms for {elems} at "
        f"{SFU_EXP_PER_S:.3e}/s, fp32 {t_fma:.5f} ms for {flops:.3e} flop) "
        f"| device time in a CUDA graph {dev_ms:.5f} ms")
    host = host_us(lambda: scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A))
    kernel_report("[k3]", "mamba_scan_kernel", flops, ms, b_ms, None,
                  sass_counts("mamba_scan_kernel", K3_SASS), dev_ms,
                  host=host)
    y = torch.empty((B, S, dI), device=dev)
    hT = torch.empty((B, dI, N), device=dev)
    cut = _time_ablations(
        ablations, "repro_mamba_scan",
        (1, dt.data_ptr(), x.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
         A.data_ptr(), None, y.data_ptr(), hT.data_ptr(), B, S, dI, N),
        lambda: scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A), timer=graph_ms)
    log(f"[k3] ablation (same shape, one part of the design changed; "
        f"device time in CUDA graphs, in turns): {_turns(cut)}")
    return dict(name="mamba_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                replaces="src/repro/kernels/mamba_scan.py:29",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ------------------------------------------------------------------ phase 7
def _pool_leaves(sstate):
    """(name, tensor) of a slot-state pool's leaves."""
    for name, v in sstate.items():
        if isinstance(v, tuple):
            yield from ((f"{name}.{i}", t) for i, t in enumerate(v))
        else:
            yield name, v


def phase_serve_ssm(dev, arch: str = "falcon-mamba-7b", tag: str = "ssm",
                    card: str = ""):
    """A slot-state arch at full width and depth through the engine:
    falcon-mamba (K3 in every prefill layer) or zamba2 (``tag`` "hybrid";
    K2 in each group's shared block); ``card`` is printed beside the serve
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.obs import Observability
    from repro_torch.params import init_params, param_bytes
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(arch)                        # full width and depth
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    wbytes = param_bytes(params)
    if cfg.hybrid_attn_every:
        shape = (f"G={cfg.num_layers // cfg.hybrid_attn_every} x "
                 f"{cfg.hybrid_attn_every} + tail "
                 f"{cfg.num_layers % cfg.hybrid_attn_every}, nh="
                 f"{cfg.ssm_heads} hp={cfg.ssm_head_dim}, shared block "
                 f"H={cfg.num_heads} KV={cfg.num_kv_heads} hd={cfg.hd} "
                 f"F={cfg.d_ff}")
    else:
        shape = f"R={cfg.dt_rank_}"
    log(f"[{tag}] {cfg.name}: L={cfg.num_layers} D={cfg.d_model} "
        f"dI={cfg.d_inner} N={cfg.ssm_state} K={cfg.ssm_conv} {shape} "
        f"V={cfg.vocab_size}; weights {wbytes / 1e9:.3f} GB (matrices "
        f"bf16) in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    obs = Observability()
    eng = ServeEngine(cfg, params, decode_chunk=8, max_batch=8, device=dev,
                      obs=obs)
    frozen = _freeze_chunk(eng, len(PROMPT_LENS) // 2)
    try:
        leaves = dict(_pool_leaves(eng._sstate))
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in leaves.values())
        per_leaf = {n: (tuple(t.shape), round(t.numel() * t.element_size()
                                              / 1e6, 1))
                    for n, t in leaves.items()}
        log(f"[{tag}] engine: paged={eng.paged}, slot pool (shape, MB) per "
            f"leaf {per_leaf}, {pool_bytes / 1e6:.1f} MB, max_seq_len "
            f"{eng._max_seq}")
        # warm-up request (cuBLAS handles, allocator), outside the counts
        eng.result(eng.submit(prompts[0][:8], max_new=2))
        torch.cuda.synchronize()
        stats0 = dict(eng.stats)
        obs.reset()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = []
        for p in prompts:
            reqs.append(eng.submit(p, max_new=MAX_NEW))
            time.sleep(0.02)
        outs = [eng.result(r, timeout=600.0) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        del eng._chunk.run          # the spy: back to the class's run
        if "state" not in frozen:
            raise SystemExit(f"[{tag}] no decode chunk with a full batch")
        # on the resting engine: close() frees the captured graph
        _rest(eng)
        _graph_vs_eager(eng, frozen, tag)
    finally:
        eng._chunk.__dict__.pop("run", None)
        eng.close()
    stats = {k: v - stats0.get(k, 0) for k, v in eng.stats.items()}
    for p, o in zip(prompts, outs):
        if o.shape != (MAX_NEW,) or not ((o >= 0) & (o < cfg.vocab_size)
                                         ).all():
            raise SystemExit(f"bad output for prompt len {len(p)}: {o}")
    B = len(eng._slot_req)
    if len(eng._free_slots) != B or eng._slots_reserved or eng._inflight:
        raise SystemExit(f"slots leaked: {len(eng._free_slots)} free of {B}")
    # the path's kernel and its launches per prefill: K3 in each Mamba1
    # layer, K2 in each group's shared block
    kernel, per = ("flash_attention", cfg.num_layers // cfg.hybrid_attn_every) \
        if cfg.hybrid_attn_every else ("mamba_scan", cfg.num_layers)
    if stats["prefills"] != len(prompts) \
            or counts[kernel] < per * stats["prefills"]:
        raise SystemExit(f"{kernel} launches {counts[kernel]} < {per} x "
                         f"{stats['prefills']} prefills")
    ttft = sorted(r.ttft for r in reqs)
    tok = len(prompts) * MAX_NEW
    log(f"[{tag}] {len(prompts)} requests, prompts {list(PROMPT_LENS)}, "
        f"max_new {MAX_NEW}: {tok} tokens in {wall:.3f}s = "
        f"{tok / wall:.1f} tok/s | TTFT p50 {ttft[len(ttft) // 2]:.4f}s "
        f"max {ttft[-1]:.4f}s on {card} | stats {stats}")
    log(f"[{tag}] launches {counts} over {stats['prefills']} prefills and "
        f"{stats['decode_cycles'] * eng.decode_chunk} decode steps; weights "
        f"{wbytes / 1e9:.3f} GB, slot pool {pool_bytes / 1e6:.1f} MB, peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; all {B} "
        f"slots free")
    log(f"[{tag}] sample: {outs[0][:16].tolist()}")
    log(f"[{tag}] {_cycle_split(obs)}")
    return cfg, params, prompts, counts


# ------------------------------------------------------------------ phase 8
def phase_steps_ssm(cfg, params, prompts, dev):
    import dataclasses

    from repro_torch.models import lm
    toks = torch.from_numpy(prompts[-1][None]).to(dev)      # 300 tokens
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        for dt, c in (("bfloat16", cfg), ("float32", cfg32)):
            p = params if dt == "bfloat16" else _fp32_params(params)
            lk, ck = lm.prefill(c, p, toks, impl="kernel")
            lp, cp = lm.prefill(c, p, toks, impl="plain")
            _compare(f"{dt} prefill S={toks.shape[1]} K3 vs plain scan", lk,
                     lp, STEP_REL_TOL[dt])
            hk, hp = ck["ssm"][1], cp["ssm"][1]
            rel = (hk - hp).abs().max().item() / hp.abs().max().item()
            log(f"[ssmstep] {dt} returned h states ({c.num_layers} layers): "
                f"max|d|/max|plain| = {rel:.3e} (tol {STEP_REL_TOL[dt]}); "
                f"conv tails equal: {torch.equal(ck['ssm'][0], cp['ssm'][0])}")
            if not (rel <= STEP_REL_TOL[dt] and torch.isfinite(hk).all()):
                raise SystemExit(f"{dt} prefill states disagree: {rel}")
            del p, ck, cp


# ------------------------------------------------------------------ phase 8b
def _k2_at_hybrid_shape(dev) -> None:
    """K2 against its plain version at the shared block's prefill shape,
    and timed beside it and SDPA (printed; the kernels line keeps the
    window-0 shape's numbers)."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels.ref import flash_attention_ref
    g = torch.Generator(dev).manual_seed(5)
    S = PROMPT_LENS[-1]
    for dtype in (BF16, F32):
        q, k, v = (torch.randn((1, S, 32, 64), generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        out = flash_mod.flash_attention_cuda(q, k, v)
        ref = flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out.float()).all().item() or err > KERNEL_TOL:
            raise SystemExit(f"K2 disagrees with its plain version at the "
                             f"hybrid shape: {err}")
        log(f"[hybridstep] K2 B=1 S=T={S} H=KV=32 hd=64 causal "
            f"{str(dtype)[6:]}: max|kernel-plain|={err:.3e} (tol "
            f"{KERNEL_TOL}) | {_k2_line(_k2_times(q, k, v))}")


def phase_steps_hybrid(cfg, params, prompts, dev):
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models import mamba as tm
    _k2_at_hybrid_shape(dev)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    # the 300-token prompt is one ragged SSD chunk; 256 tokens are two
    # chunks of ssm_chunk=128, the carried-state path
    seqs = [prompts[-1], np.resize(prompts[-1], 2 * cfg.ssm_chunk)]
    with torch.inference_mode():
        for dt, c in (("bfloat16", cfg), ("float32", cfg32)):
            p = params if dt == "bfloat16" else _fp32_params(params)
            for seq in seqs:
                toks = torch.from_numpy(seq[None]).to(dev)
                lf, cf = lm.prefill(c, p, toks, impl="flash")
                lp, cp = lm.prefill(c, p, toks, impl="chunked")
                _compare(f"{dt} prefill S={toks.shape[1]} K2 vs chunked", lf,
                         lp, STEP_REL_TOL[dt])
                rels = {}
                for name in ("g_ssm", "tail_ssm", "shared_k", "shared_v"):
                    a, b = cf[name], cp[name]
                    for i, (x, y) in enumerate(zip(
                            a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,))):
                        if not torch.isfinite(x.float()).all():
                            raise SystemExit(f"{name} not finite")
                        rels[f"{name}.{i}"] = ((x.float() - y.float()).abs()
                                               .max() / y.float().abs().max()
                                               ).item()
                log(f"[hybridstep] {dt} S={toks.shape[1]} returned state "
                    f"leaves, max|d|/max|plain|: "
                    + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
                    + f" (tol {STEP_REL_TOL[dt]})")
                if max(rels.values()) > STEP_REL_TOL[dt]:
                    raise SystemExit(f"{dt} prefill states disagree: {rels}")
            del p, cf, cp
        # one Mamba2 layer at full width, fp32: the SSD dual form over S
        # tokens against S steps of the recurrence from a zero state
        p32 = {k: v[0, 0].float() for k, v in params["gblocks"].items()}
        S = 2 * cfg.ssm_chunk
        g = torch.Generator(dev).manual_seed(6)
        x = torch.randn((1, S, cfg.d_model), generator=g, device=dev)
        t0 = time.perf_counter()
        y, (tail, h) = tm._m2_forward(p32, x, cfg32, return_state=True)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        state = tm.init_mamba_state(cfg32, 1, torch.float32, dev)
        ys = []
        for t in range(S):
            yt, state = tm._m2_step(p32, x[:, t], cfg32, state)
            ys.append(yt)
        ys = torch.stack(ys, dim=1)
        ey = ((y - ys).abs().max() / ys.abs().max()).item()
        eh = ((h - state[1]).abs().max() / state[1].abs().max()).item()
        et = (tail - state[0]).abs().max().item()
        log(f"[hybridstep] Mamba2 layer fp32 nh={cfg.ssm_heads} "
            f"hp={cfg.ssm_head_dim} N={cfg.ssm_state} dI={cfg.d_inner} "
            f"S={S} ({S // cfg.ssm_chunk} SSD chunks, {fwd_s * 1e3:.1f} ms): "
            f"SSD vs {S} recurrence steps max|d|/max|steps| y {ey:.3e} h "
            f"{eh:.3e} (tol {SSD_REL_TOL}); conv tail max|d| {et:.3e}")
        if not (max(ey, eh) <= SSD_REL_TOL and torch.isfinite(y).all()
                and et <= SSD_REL_TOL):
            raise SystemExit(f"SSD disagrees with the recurrence: {ey}, {eh}")


# ------------------------------------------------------------------ phase 8d
def _k1_k2_at_moe_shape(dev) -> None:
    """K1 and K2 against their plain versions at qwen2-moe's attention
    shapes (H = KV = 16, hd = 128, bf16): K1 over a decode batch of 8 rows
    at the serve phase's ragged lengths, K2 over the window-0 prefill of 4
    rows of 128 tokens; each timed beside its plain version, SDPA and its
    bound (printed; the kernels line keeps stablelm's shapes)."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         paged_attention_ref)
    lengths = [-1, 15, 16, 47, 100, 200, 331, 255]
    q, pool, tables, ln = _paged_case(8, 16, 16, 128, 16, 128, 32, lengths,
                                      dev, seed=128)
    out = paged_mod.paged_attention_cuda(q, pool, tables, ln)
    ref = paged_attention_ref(q, pool, tables, ln)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out.float()).all().item() or err > KERNEL_TOL:
        raise SystemExit(f"K1 disagrees with its plain version at hd=128: "
                         f"{err}")
    log(f"[moestep] K1 B=8 H=KV=16 hd=128 bs=16 lengths={lengths} bf16: "
        f"max|kernel-plain|={err:.3e} (tol {KERNEL_TOL}) | "
        f"{_k1_line(_k1_times(q, pool, tables, ln))}")
    g = torch.Generator(dev).manual_seed(7)
    q, k, v = (torch.randn((4, 128, 16, 128), generator=g, device=dev
                           ).bfloat16() for _ in range(3))
    out = flash_mod.flash_attention_cuda(q, k, v)
    ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out.float()).all().item() or err > KERNEL_TOL:
        raise SystemExit(f"K2 disagrees with its plain version at hd=128: "
                         f"{err}")
    log(f"[moestep] K2 B=4 S=T=128 H=KV=16 hd=128 causal bf16: "
        f"max|kernel-plain|={err:.3e} (tol {KERNEL_TOL}) | "
        f"{_k2_line(_k2_times(q, k, v))}")


def phase_steps_moe(cfg, params, prompts, frozen, dev) -> None:
    """K1 and K2 at the MoE shapes; the decode step and window-0 prefill
    checks of ``phase_steps`` (fp32 at MOE_FP32_LAYERS layers); the share of
    (token, expert) assignments the window-0 prefill drops over capacity;
    and ``moe_layer`` run twice on the same CUDA input, which must agree
    bit for bit (the combine sums in a fixed order, without atomics)."""
    from repro_torch.models import lm
    from repro_torch.models import moe
    _k1_k2_at_moe_shape(dev)
    phase_steps(cfg, params, prompts, frozen, dev, tag="moestep",
                fp32_layers=MOE_FP32_LAYERS)
    seen = []
    real = lm.moe_layer

    def spy(p, x, cfg_, **kw):
        seen.append((p, x.clone()))
        return real(p, x, cfg_, **kw)

    lm.moe_layer = spy
    try:
        with torch.inference_mode():
            lm.prefill(cfg, params, _window0(prompts, dev))
    finally:
        lm.moe_layer = real
    with torch.inference_mode():
        dropped, total = 0, 0
        for p, x in seen:
            r = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
            dropped += int((r.rank >= r.capacity).sum())
            total += r.rank.numel()
        T = total // cfg.num_experts_per_tok // len(seen)
        load = T * cfg.num_experts_per_tok / cfg.num_experts
        log(f"[moestep] window-0 prefill (4 x 128 tokens, T={T}, capacity "
            f"{r.capacity} per expert, mean load {load:.1f}): {dropped} of "
            f"{total} assignments dropped over {len(seen)} layers = "
            f"{dropped / total:.4%}")
        p, x = seen[-1]
        for what, xx in (("window-0 T=512", x),
                         ("decode B=8", x.reshape(-1, cfg.d_model)[:8, None])):
            a, b = moe.moe_layer(p, xx, cfg), moe.moe_layer(p, xx, cfg)
            a, b = moe.moe_layer(p, x, cfg), moe.moe_layer(p, x, cfg)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            log(f"[moestep] moe_layer twice on one CUDA input ({what}): "
                f"bitwise equal {same}, finite "
                f"{bool(torch.isfinite(a.float()).all())}")
            if not same:
                raise SystemExit(f"moe_layer is not repeatable ({what})")


# ------------------------------------------------------------------ phase 8e
def train_model_flops(cfg, batch: int, seq: int):
    """One step's model FLOPs by the PaLM count, ``6 N tokens + 12 L_attn D
    S tokens``: N the matmul weights a token passes through (attention and
    MLP layers; a Mamba1 layer's in, x, dt and out projections; a Mamba2
    layer's in and out projections and, G times, the hybrid's shared
    block; the LM head; the embedding gather is no matmul) and L_attn the
    attention layers it passes. The scans' own work and remat's second
    forward are not counted. Returns (flops, N)."""
    D, L = cfg.d_model, cfg.num_layers
    attn = 2 * D * cfg.num_heads * cfg.hd + 2 * D * cfg.num_kv_heads * cfg.hd
    mlp = (3 if cfg.mlp_gated else 2) * D * cfg.d_ff
    dI, Ns = cfg.d_inner, cfg.ssm_state
    if not cfg.ssm:
        n, l_attn = L * (attn + mlp), L
    elif cfg.ssm_version == 1:
        n = L * (D * 2 * dI + dI * (cfg.dt_rank_ + 2 * Ns)
                 + cfg.dt_rank_ * dI + dI * D)
        l_attn = 0
    else:
        l_attn = L // cfg.hybrid_attn_every
        n = L * (D * (2 * dI + 2 * Ns + cfg.ssm_heads) + dI * D) \
            + l_attn * (2 * D * D + attn + mlp)
    n += D * cfg.padded_vocab
    tokens = batch * seq
    return 6.0 * n * tokens + 12.0 * l_attn * D * seq * tokens, n


def _profile_rows(fn):
    """(device busy ms, kernel launches, every kernel's (name, ms, count)
    by time) of one call, from ``torch.profiler``'s device activity alone,
    read from its raw events (a step launches ~130k kernels: the
    per-operator tables would cost minutes to build)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            r = by_name.setdefault(e.name(), [0.0, 0])
            r[0] += e.duration_ns() / 1e6
            r[1] += 1
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def _kernel_class(name: str) -> str:
    """A kernel's class in a train profile: K3 and its backward, cuBLAS's
    fp32 FFMA GEMMs (the chunked attention's fp32 QK products and the fp32
    logits products), the other GEMMs (bf16 on the tensor cores), or the
    rest."""
    if "mamba_scan_bwd" in name:
        return "K3 backward"
    if "mamba_scan_kernel" in name:
        return "K3"
    if "f32f32_f32f32" in name or "sgemm" in name:
        return "fp32 gemm"
    if any(k in name for k in ("gemm", "nvjet", "cutlass")):
        return "other gemm"
    return "other"


def _weights_probe(params) -> dict:
    """A corner of every leaf of two or more dimensions (the leaves AdamW
    decays, so each moves in a step whatever its gradient)."""
    return {n: t[..., :8, :8].clone() for n, t in _named_leaves(params)
            if t.dim() >= 2}


def phase_train(dev, card: str = "") -> dict:
    """stablelm-1.6b at full width and depth (24 layers, d_model 2048, 32
    heads of 64, d_ff 5632, vocab 100352) trained through
    :func:`_train_run` for TRAIN_STEPS steps, the launcher's ``full``
    preset with its batch cut from 256 x 4096 to TRAIN_BATCH x TRAIN_SEQ
    (one sequence per microbatch) so the phase stays near 90 s; no
    checkpoint directory. The first loss must lie within 1 nat of ln(V).
    Then, from the trained state: one step under
    ``torch.cuda.set_sync_debug_mode("error")`` with its batch on the card
    (a step that is not a log step makes no host sync) and one timed
    snapshot of params and optimizer state into host memory (what
    ``ckpt-save`` does on the critical path; nothing is written to disk).
    Then ``phase_train_checks``."""
    from repro_torch.launch.train import build_cfg
    from repro_torch.optim import OptConfig
    from repro_torch.tree import leaves
    from repro_torch.train.trainer import host_snapshot

    cfg, full_batch, full_seq = build_cfg("stablelm-1.6b", "full")
    log(f"[train] {cfg.name}: H={cfg.num_heads} hd={cfg.hd} F={cfg.d_ff} "
        f"V={cfg.vocab_size}; batch {TRAIN_BATCH} x seq {TRAIN_SEQ} is the "
        f"full preset's {full_batch} x {full_seq}, cut")

    def then(step, params, opt_state, batch) -> dict:
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, opt_state, m = step(params, opt_state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[train] one step under set_sync_debug_mode('error'), batch "
            f"on the card: no host sync; loss {float(m['loss']):.6f}")
        if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
            raise SystemExit("train: the sync-debug step is not finite")
        snap_tree = {"params": params, "opt": opt_state}
        nbytes = sum(t.numel() * t.element_size() for t in leaves(snap_tree))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = host_snapshot(snap_tree)
        snap_s = time.perf_counter() - t0
        del snap
        log(f"[train] ckpt-save snapshot (synchronous copy to host memory, "
            f"on the critical path): {nbytes / 1e9:.3f} GB in {snap_s:.3f} "
            f"s ({nbytes / snap_s / 1e9:.2f} GB/s); not written to disk")
        return {"snapshot_bytes": nbytes, "snapshot_s": snap_s}

    summary = _train_run(dev, cfg, "train", card, TRAIN_STEPS, then=then)
    if abs(summary["loss"][0] - np.log(cfg.vocab_size)) > 1.0:
        raise SystemExit(f"train: first loss {summary['loss'][0]} is not "
                         f"within 1 nat of ln(V) = {np.log(cfg.vocab_size)}")
    opt = OptConfig(lr=3e-4, warmup_steps=max(10, TRAIN_STEPS // 20),
                    total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    summary.update(phase_train_checks(dev, cfg, opt))
    log(f"[time] train: bf16/fp32 and checkpoint checks "
        f"{time.perf_counter() - t0:.1f}s")
    log(f"[train] summary {json.dumps(summary)}")
    return summary


def phase_train_checks(dev, cfg, opt) -> dict:
    """At full width and TRAIN_CHECK_LAYERS layers: one ``train_step`` in
    bf16 and in fp32 compute from the same fp32 weights and batch (2 x
    TRAIN_SEQ, 2 microbatches), loss and grad norm within TRAIN_BF16_TOL.
    Then the checkpoint branch at smoke size on the card: ``ckpt_every=2``,
    ``fail_at_step=3`` gives one restart from the step-2 checkpoint, the
    run ends at step 4, and the re-run step 2's loss equals the first
    run's within TRAIN_RERUN_REL (the embedding backward's atomics may
    change the last bits)."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.params import init_params
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_map

    c4 = dataclasses.replace(cfg, num_layers=TRAIN_CHECK_LAYERS)
    base = init_params(c4, torch.Generator(dev).manual_seed(1), device=dev,
                       cast=False)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, c4.vocab_size, (2, TRAIN_SEQ)).astype(np.int32)).to(dev)
    got = {}
    for dt in ("bfloat16", "float32"):
        cc = dataclasses.replace(c4, compute_dtype=dt)
        p = tree_map(torch.clone, base)
        _, _, m = make_train_step(cc, opt, microbatches=2)(
            p, init_opt_state(p, opt), {"tokens": toks})
        got[dt] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        del p, m
    del base
    gc.collect()
    torch.cuda.empty_cache()
    d_loss = abs(got["bfloat16"]["loss"] - got["float32"]["loss"])
    d_gn = abs(got["bfloat16"]["grad_norm"] - got["float32"]["grad_norm"]) \
        / got["float32"]["grad_norm"]
    log(f"[train] {TRAIN_CHECK_LAYERS} layers, full width, 2 x {TRAIN_SEQ}: "
        f"bf16 {got['bfloat16']} | fp32 {got['float32']} | |d loss| "
        f"{d_loss:.6f} nats (tol {TRAIN_BF16_TOL['loss']}), grad norm "
        f"{d_gn:.6f} relative (tol {TRAIN_BF16_TOL['grad_norm']})")
    if d_loss > TRAIN_BF16_TOL["loss"] or d_gn > TRAIN_BF16_TOL["grad_norm"]:
        raise SystemExit("train: bf16 and fp32 compute disagree")

    ckdir = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    tc = TrainerConfig(total_steps=4, ckpt_every=2, log_every=1,
                       fail_at_step=3)
    try:
        out = Trainer(get_config("stablelm-1.6b").smoke(), tc, batch=4,
                      seq_len=64, opt=OptConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=4),
                      ckpt_dir=str(ckdir), device=dev).run()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    steps = [h["step"] for h in out["history"]]
    first, again = [h["loss"] for h in out["history"] if h["step"] == 2][:2] \
        if steps.count(2) == 2 else (float("nan"), float("nan"))
    rel = abs(first - again) / abs(first)
    log(f"[train] checkpoint branch (smoke size, on the card): restarts "
        f"{out['restarts']}, final step {out['state']['step']}, steps "
        f"logged {steps}, re-run step 2 loss {again!r} vs {first!r} "
        f"(relative {rel:.3e}, tol {TRAIN_RERUN_REL})")
    if out["restarts"] != 1 or out["state"]["step"] != 4 \
            or not rel <= TRAIN_RERUN_REL:
        raise SystemExit("train: the checkpoint branch failed")
    return {"bf16_vs_fp32": got, "rerun_rel": rel}


# ------------------------------------------------------------------ phase 8f
def _scan_grads(fn, ins, dy, dhT=None):
    """Gradients of ``fn(*ins) -> (y, hT)`` against (dy, dhT) for every
    input, through fresh leaves."""
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    y, hT = fn(*ins)
    outs, gouts = [y], [dy]
    if dhT is not None:
        outs.append(hT)
        gouts.append(dhT)
    return torch.autograd.grad(outs, ins, gouts)


def _k3bwd_states_match(dev, B=2, S=250, dI=512, N=16, dstar=300) -> bool:
    """The backward's recomputed states are K3's, bit for bit: with dy one
    at channel ``dstar`` and zero elsewhere (fp32), dC_t[n] is h_t[dstar,
    n] summed with zeros; K3 with C the n-th unit vector gives y_t[d] =
    h_t[d, n] the same way."""
    from repro_torch.kernels import mamba_scan as scan_mod
    from repro_torch.kernels import mamba_scan_bwd as bwd_mod
    g = torch.Generator(dev).manual_seed(6)
    dt = F.softplus(torch.randn((B, S, dI), generator=g, device=dev)) * 0.1
    x, Bc, Cc = (torch.randn(shape, generator=g, device=dev)
                 for shape in ((B, S, dI), (B, S, N), (B, S, N)))
    A = -torch.exp(torch.randn((dI, N), generator=g, device=dev) * 0.5)
    _, _, hs = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, save_states=True)
    dy = torch.zeros((B, S, dI), device=dev)
    dy[:, :, dstar] = 1.0
    dC = bwd_mod.mamba_scan_bwd_cuda(dt, x, Bc, Cc, A, hs, dy)[3]
    ok = True
    for n in range(N):
        e = torch.zeros((B, S, N), device=dev)
        e[:, :, n] = 1.0
        y, _ = scan_mod.mamba_scan_cuda(dt, x, Bc, e, A)
        ok = ok and torch.equal(dC[:, :, n], y[:, :, dstar])
    return ok


def phase_k3bwd(dev, other=None, ablations=False):
    """The backward kernel (``csrc/mamba_scan_bwd.cu``, behind
    ``MambaScan``) against ``torch.autograd`` through the plain
    sequential scan: the training layout at a reduced size (B=2, S=250, off
    the 32-step chunks, dI=512, N=16) in fp32 and with bf16 x/B/C, a
    ragged dI with an initial state and a final-state gradient, N=12; then
    at the training shape (one falcon-mamba sequence: B=1, S=2048, dI=8192,
    N=16, bf16 x/B/C) compared again and timed beside its bound and the
    plain backward (no PyTorch call computes a selective scan's gradient),
    with K3's serving and training entry points timed at that shape too;
    two calls bitwise equal; the recomputed states K3's; registers and
    resident blocks per SM. ``other``'s ``mamba_scan_bwd.cu`` (another
    tree's, whose C entry takes this tree's arguments, as the design
    before this one does) and, with ``ablations``, the K3BWD_ABLATIONS
    copies are timed in turns beside this tree's in CUDA graphs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_scan as scan_mod
    from repro_torch.kernels import mamba_scan_bwd as bwd_mod
    from repro_torch.kernels.ref import mamba_scan_ref
    builds = _build_ablations("mamba_scan_bwd.cu",
                              K3BWD_ABLATIONS if ablations else {}, other)
    # (they build while the checks run)
    g = torch.Generator(dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def inputs(B, S, dI, N, dtype):
        return [F.softplus(randn(B, S, dI)) * 0.1, randn(B, S, dI).to(dtype),
                randn(B, S, N).to(dtype), randn(B, S, N).to(dtype),
                -torch.exp(randn(dI, N) * 0.5)]

    def compare(what, ins, dtype, init, dy, dhT):
        got = _scan_grads(lambda dt, x, b, c, a: scan_mod.MambaScan.apply(
            dt, x, b, c, a, init), ins, dy, dhT)
        want = _scan_grads(lambda dt, x, b, c, a: mamba_scan_ref(
            dt, a, b, c, x, h0=init), ins, dy, dhT)
        torch.cuda.synchronize()
        rel = {n: _rel(a, b) for n, a, b in zip(("dt", "x", "B", "C", "A"),
                                                 got, want)}
        ok = all(torch.isfinite(a.float()).all().item() for a in got)
        log(f"[k3bwd] {what} B={ins[1].shape[0]} S={ins[1].shape[1]} "
            f"dI={ins[1].shape[2]} N={ins[4].shape[1]} {str(dtype)[6:]}"
            f"{', h0' if init is not None else ''}"
            f"{', dhT' if dhT is not None else ''}: max|kernel - plain| / "
            f"max|plain| " + ", ".join(f"d{k} {v:.3e}" for k, v in
                                       rel.items())
            + f" (tol {K3BWD_REL_TOL[dtype]})")
        if not ok or max(rel.values()) > K3BWD_REL_TOL[dtype]:
            raise SystemExit(f"the K3 backward disagrees with autograd "
                             f"through the plain scan ({what}): {rel}")
        return max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(got, want))

    errs = []
    for what, B, S, dI, N, dtype, h0, fin in (
            ("training layout, reduced", 2, 250, 512, 16, F32, False, False),
            ("training layout, reduced", 2, 250, 512, 16, BF16, False,
             False),
            ("ragged dI", 2, 45, 500, 16, F32, True, True),
            ("N < 16", 1, 70, 256, 12, F32, False, True)):
        ins = inputs(B, S, dI, N, dtype)
        errs.append(compare(what, ins, dtype,
                            randn(B, dI, N) if h0 else None,
                            randn(B, S, dI), randn(B, dI, N) if fin else None))
    if not _k3bwd_states_match(dev):
        raise SystemExit("the K3 backward's recomputed states are not K3's")
    log("[k3bwd] recomputed states equal K3's bit for bit (dC against K3's "
        "y with unit-vector C, fp32, B=2 S=250 dI=512)")

    B, S, dI, N = K3BWD_SHAPE
    ins = inputs(B, S, dI, N, BF16)
    dt, x, Bc, Cc, A = ins
    dy = randn(B, S, dI)
    errs.append(compare("training shape", ins, BF16, None, dy, None))
    _, _, hs = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, save_states=True)

    def run():
        return bwd_mod.mamba_scan_bwd_cuda(dt, x, Bc, Cc, A, hs, dy)

    one, again = run(), run()
    if not all(torch.equal(a, b) for a, b in zip(one, again)):
        raise SystemExit("the K3 backward is not deterministic")
    nch = -(-S // scan_mod.STATE_CHUNK)
    ms = time_ms(run, iters=20)
    dev_ms = graph_ms(run, n=5, replays=4)
    host = host_us(run, iters=20)
    fwd = time_ms(lambda: scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A),
                  iters=20)
    fwd_states = time_ms(lambda: scan_mod.mamba_scan_cuda(
        dt, x, Bc, Cc, A, save_states=True), iters=20)
    leaves_ = [t.detach().requires_grad_(True) for t in ins]
    yr, _ = mamba_scan_ref(leaves_[0], leaves_[4], leaves_[2], leaves_[3],
                           leaves_[1])
    plain_ms = time_ms(lambda: torch.autograd.grad(yr, leaves_, dy,
                                                   retain_graph=True),
                       iters=2, warmup=1)
    del yr, leaves_
    elems = B * S * dI * N
    # read once: dt, dy (fp32), x, B, C (bf16), A, hs; written once: d dt
    # (fp32), dx, dB, dC (bf16, x's type), dA
    nbytes = (4 + 4 + 2 + 4 + 2) * B * S * dI + 4 * 2 * B * S * N \
        + 2 * 4 * dI * N + 4 * B * nch * dI * N
    # per (b, t, d, n): the state again (mul + FMA) and the reverse step's
    # g (FMA), w (2 mul), two n-sum FMAs, the dA FMA, dB and dC products
    # and g * a; one exp
    flops = 16.0 * elems
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = elems / SFU_EXP_PER_S * 1e3
    t_fma = flops / FP32_FLOPS_PER_S * 1e3
    b_ms = max(t_b, t_exp, t_fma)
    b_by = "bytes" if t_b >= max(t_exp, t_fma) else "operations"
    log(f"[k3bwd] timing B={B} S={S} dI={dI} N={N} bf16 x/B/C: kernel "
        f"{ms:.4f} ms | plain (autograd backward through the sequential "
        f"scan) {plain_ms:.2f} ms | no library call computes it | bound "
        f"{b_ms:.5f} ms ({b_by}: bytes {t_b:.5f} ms for {nbytes} B, exps "
        f"{t_exp:.5f} ms for {elems}, fp32 {t_fma:.5f} ms for {flops:.3e} "
        f"flop) | device time in a CUDA graph {dev_ms:.5f} ms | K3 at this "
        f"shape: serving entry {fwd:.4f} ms, training entry (states kept, "
        f"{4 * B * nch * dI * N / 1e6:.1f} MB) {fwd_states:.4f} ms")
    log("[k3bwd] two calls at the training shape bitwise equal")
    kernel_report("[k3bwd]", "mamba_scan_bwd", flops, ms, b_ms, None,
                  sass_counts("mamba_scan_bwd", K3_SASS), dev_ms, host=host)
    occ = bwd_mod.occupancy(BF16)

    def regs_of(text=None):
        """Registers a thread of the bf16 reverse scan (this tree's
        16-byte staging copy) in a build's ptxas log."""
        for ln in ptxas_of("mamba_scan_bwd_kernel", text):
            if "__nv_bfloat16" in ln and "registers" in ln \
                    and "false>" not in ln:
                return int(ln.split("Used ")[1].split()[0])
        return None

    regs = {"kernel": regs_of()}
    log(f"[k3bwd] reverse scan (bf16): {regs['kernel']} registers a "
        f"thread, {occ[0]} resident block(s) per SM (CUDA runtime, 8 warps "
        f"a block); sum kernel {occ[1]}")
    if not builds:
        return _k3bwd_entry(errs, ms, plain_ms, b_ms, b_by)
    f32 = dict(dtype=torch.float32, device=dev)

    def c_args():
        """The C entry's arguments at this shape with fresh outputs (d dt,
        dx, dB, dC, dA, part, dA_part), and those outputs."""
        outs = [torch.empty((B, S, dI), **f32),
                torch.empty((B, S, dI), dtype=BF16, device=dev),
                torch.empty((B, S, N), dtype=BF16, device=dev),
                torch.empty((B, S, N), dtype=BF16, device=dev),
                torch.empty((dI, N), **f32),
                torch.empty((-(-dI // 64), B, S, 32), **f32),
                torch.empty((B, dI, N), **f32)]
        return (_build.BFLOAT16, *(t.data_ptr() for t in (
            dt, x, Bc, Cc, A, hs, dy)), None,
            *(t.data_ptr() for t in outs), B, S, dI, N), outs

    cut_args, cut_outs = c_args()
    other_args, other_outs = c_args()
    libs, logs = {}, {}
    turns = _time_ablations(
        builds, "repro_mamba_scan_bwd", cut_args, run,
        init="repro_mamba_scan_bwd_init",
        timer=lambda f: graph_ms(f, n=5, replays=4),
        args_of={"other": other_args}, libs=libs, logs=logs)
    log(f"[k3bwd] in turns (same shape; device time in CUDA graphs"
        f"{', ablations: one part cut out' if ablations else ''}): "
        f"{_turns(turns)}")
    if other is not None:
        torch.cuda.synchronize()
        diff = max((a.float() - b.float()).abs().max().item()
                   / max(a.float().abs().max().item(), 1e-30)
                   for a, b in zip(one, other_outs))
        regs["other"] = regs_of(logs["other"])
        # the other build's occupancy where it exports the entry that
        # reports it (the design before this one does not)
        occ_other = "not reported by its build"
        fn = getattr(libs["other"], "repro_mamba_scan_bwd_occupancy", None)
        if fn is not None:
            out = (ctypes.c_int * 2)()
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            if fn(_build.BFLOAT16, out) == 0:
                occ_other = str(out[0])
        log(f"[k3bwd] this tree against --other-csrc, device time in CUDA "
            f"graphs in turns: this "
            f"{min(turns['kernel']):.5f}-{max(turns['kernel']):.5f} ms, "
            f"other {min(turns['other']):.5f}-{max(turns['other']):.5f} ms; "
            f"registers a thread (bf16 reverse scan) {regs.get('kernel')} "
            f"against {regs.get('other')}; resident blocks per SM {occ[0]} "
            f"against {occ_other}; max |this - other| / max |this| "
            f"{diff:.3e}")
    return _k3bwd_entry(errs, ms, plain_ms, b_ms, b_by)


def _k3bwd_entry(errs, ms, plain_ms, b_ms, b_by) -> dict:
    """The backward's entry of the kernels line."""
    return dict(name="mamba_scan_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
                replaces="src/repro/models/mamba.py:70",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# ------------------------------------------------------------------ phase 8g
def _train_run(dev, cfg, tag: str, card: str, steps: int,
               then=None) -> dict:
    """``steps`` steps of TRAIN_BATCH x TRAIN_SEQ through the port's
    ``Trainer`` (the cyclic conditional taskflow: prefetch, train-step,
    ckpt?, loop?; fp32 masters from a seeded ``torch.Generator``, AdamW
    with fp32 moments, the launcher's schedule, bf16 compute with remat,
    one sequence a microbatch), then one step traced with
    ``torch.profiler`` on the trained state. Fails unless every loss is
    finite, the losses move and every probed weight moved. ``then(step,
    params, opt_state, batch)``, if given, runs on the trained state last
    and its dict joins the summary. Returns the summary with the kernels'
    launches over the trainer's steps and the traced one."""
    from repro_torch.kernels import ops
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.train_step import make_train_step

    B, S = TRAIN_BATCH, TRAIN_SEQ
    nf = cfg.frontend_tokens if cfg.frontend != "none" else 0
    flops, n_matmul = train_model_flops(cfg, B, S + nf)
    opt = OptConfig(lr=3e-4, warmup_steps=max(10, steps // 20),
                    total_steps=steps)
    tc = TrainerConfig(total_steps=steps, log_every=1,
                       microbatches=TRAIN_MB)
    log(f"[{tag}] {cfg.name}: L={cfg.num_layers} D={cfg.d_model} "
        f"{cfg.param_count() / 1e9:.3f} B params, compute "
        f"{cfg.compute_dtype}, remat={cfg.remat}, fp32 masters and moments; "
        f"batch {B} x seq {S}" + (f" after {nf} stub frames" if nf else "")
        + f", {TRAIN_MB} microbatches; model FLOPs/step {flops:.4e} "
        f"(N_matmul {n_matmul})")
    tr = Trainer(cfg, tc, batch=B, seq_len=S, opt=opt, device=dev)
    probe = {}
    draw = tr.init_state

    def init_state():
        st = draw()
        probe.update(_weights_probe(st["params"]))
        return st

    tr.init_state = init_state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = tr.run()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    hist = out["history"]
    walls = [b["time"] - a["time"] for a, b in zip(hist, hist[1:])]
    wall = float(np.median(walls))
    for h in hist:
        log(f"[{tag}] step {h['step']} loss {h['loss']:.6f} ce "
            f"{h['ce']:.6f} grad_norm {h['grad_norm']:.6f} lr "
            f"{h['lr']:.3e}")
    tok_s = B * S / wall
    mfu = flops / wall / BF16_FLOPS_PER_S
    log(f"[{tag}] {card}: {len(hist)} steps in {run_s:.2f}s (init "
        f"included); step wall, steps 2-{len(hist)}: "
        f"{', '.join(f'{w:.4f}' for w in walls)} s, median {wall:.4f} s | "
        f"{tok_s:.1f} tok/s | MFU {mfu:.4f} of {BF16_FLOPS_PER_S / 1e12:.0f}"
        f" TFLOP/s bf16 ({flops / wall / 1e12:.1f} TFLOP/s) | peak device "
        f"memory {peak / 1e9:.3f} GB")
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(np.isfinite(
            losses + [h["grad_norm"] for h in hist])) \
            or len(set(losses)) < 2:
        raise SystemExit(f"{tag}: want {steps} finite steps whose losses "
                         f"move: {hist}")
    params, opt_state = out["state"]["params"], out["state"]["opt"]
    moved = {k: float((probe[k] - v).abs().max())
             for k, v in _weights_probe(params).items()}
    least = min(moved, key=moved.get)
    log(f"[{tag}] weights moved on {sum(v > 0 for v in moved.values())} of "
        f"{len(moved)} probed leaves (max |after - before| on a corner of "
        f"each; least {least} {moved[least]:.3e})")
    if not all(v > 0 for v in moved.values()):
        raise SystemExit(f"{tag}: weights did not change: {moved}")
    del out
    log(f"[time] {tag}: {steps} trainer steps {time.perf_counter() - t0:.1f}s")
    step = make_train_step(cfg, opt, microbatches=TRAIN_MB)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in tr.data.batch_at(steps).items()}
    t0 = time.perf_counter()
    busy, launches, rows = _profile_rows(
        lambda: step(params, opt_state, batch))
    counts = ops.launch_counts()
    classes = {}
    for name, ms, count in rows:
        c = classes.setdefault(_kernel_class(name), [0.0, 0])
        c[0] += ms
        c[1] += count
    log(f"[{tag}] profile of one step ({time.perf_counter() - t0:.1f} s "
        f"with the trace): device busy {busy:.1f} ms | idle "
        f"{1 - busy / (wall * 1e3):.1%} of the {wall * 1e3:.1f} ms step "
        f"wall | {launches} kernel launches | by class: "
        + "; ".join(f"{k} {v[0]:.1f} ms x{v[1]}"
                    for k, v in sorted(classes.items())))
    for name, ms, count in rows[:14]:
        log(f"    {ms:10.2f} ms  {ms / busy:6.1%}  x{count:<6d} {name[:100]}")
    for name, ms, count in rows[14:]:
        if _kernel_class(name) == "fp32 gemm":
            log(f"    fp32 gemm {ms:10.2f} ms  x{count:<6d} {name[:100]}")
    log(f"[{tag}] launches over the {steps} trainer steps and the traced "
        f"one: {counts}")
    summary = {"wall_s": walls, "median_wall_s": wall, "tokens_per_s": tok_s,
               "model_flops": flops, "mfu": mfu, "peak_bytes": peak,
               "busy_ms": busy, "idle": 1 - busy / (wall * 1e3),
               "launches": launches, "loss": losses,
               "grad_norm": [h["grad_norm"] for h in hist],
               "counts": counts, "classes": classes,
               "top": [(n, ms, c) for n, ms, c in rows[:14]]}
    if then is not None:
        summary.update(then(step, params, opt_state, batch))
    del params, opt_state, batch, tr, step
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def _named_leaves(tree, prefix=""):
    """(name, leaf) in :func:`repro_torch.tree.leaves`'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _step_on_both(dev, cfg, batch) -> dict:
    """``loss_fn`` and every leaf's gradient of one fp32 batch on the card
    and on the CPU from the same weights (drawn on the card, copied):
    |d loss| relative and, per leaf, max |d grad| / max |grad on the
    CPU|."""
    from repro_torch.models import lm
    from repro_torch.params import init_params
    from repro_torch.tree import leaves, tree_map, unflatten
    base = init_params(cfg, torch.Generator(dev).manual_seed(2), device=dev,
                       cast=False)
    got = {}
    for where in ("cuda", "cpu"):
        p = base if where == "cuda" else tree_map(lambda t: t.cpu(), base)
        flat = [t.detach().requires_grad_(True) for t in leaves(p)]
        b = {k: v.to(dev if where == "cuda" else "cpu")
             for k, v in batch.items()}
        total, _ = lm.loss_fn(cfg, unflatten(p, flat), b)
        grads = torch.autograd.grad(total, flat)
        got[where] = (float(total.detach()), [gr.cpu() for gr in grads])
        del p, flat, grads, total
    names = [n for n, _ in _named_leaves(base)]
    del base
    gc.collect()
    torch.cuda.empty_cache()
    d_loss = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    rel = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for n, a, b in zip(names, got["cuda"][1], got["cpu"][1])}
    worst = max(rel, key=rel.get)
    return {"loss_cuda": got["cuda"][0], "loss_cpu": got["cpu"][0],
            "d_loss_rel": d_loss, "worst_leaf": worst,
            "worst_grad_rel": rel[worst], "leaves": len(rel)}


def phase_train_ssm(dev, card: str = "") -> dict:
    """Training of the Mamba families. First, in fp32 at full width and
    SSM_CHECK layers, one batch's loss and every gradient on the card (K3
    and its backward kernel; the SSD in plain torch) against the CPU's
    (the plain scan under autograd). Then TRAIN_SSM_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ through the ``Trainer`` for zamba2-1.2b at full
    width and depth and falcon-mamba-7b at full width cut to
    FALCON_TRAIN_LAYERS of 64 layers, each with a traced step. Returns
    each run's summary."""
    import dataclasses

    from repro_torch.configs import get_config

    out = {}
    for arch, layers in SSM_CHECK.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  compute_dtype="float32")
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab_size, SSM_CHECK_SHAPE).astype(np.int32)
        t0 = time.perf_counter()
        chk = _step_on_both(dev, cfg, {"tokens": torch.from_numpy(toks)})
        log(f"[train_ssm] {arch} at full width, {layers} layers, fp32, "
            f"{SSM_CHECK_SHAPE[0]} x {SSM_CHECK_SHAPE[1]} tokens: loss "
            f"CUDA {chk['loss_cuda']!r} CPU {chk['loss_cpu']!r} (relative "
            f"{chk['d_loss_rel']:.3e}, tol {SSM_CHECK_TOL['loss']}); "
            f"worst of {chk['leaves']} gradient leaves {chk['worst_leaf']} "
            f"{chk['worst_grad_rel']:.3e} of its max (tol "
            f"{SSM_CHECK_TOL['grad']}) ({time.perf_counter() - t0:.1f} s)")
        if chk["d_loss_rel"] > SSM_CHECK_TOL["loss"] \
                or chk["worst_grad_rel"] > SSM_CHECK_TOL["grad"]:
            raise SystemExit(f"train_ssm: {arch}'s CUDA step differs from "
                             f"the CPU's: {chk}")
        out[f"{arch}_check"] = chk
    for arch, layers in (("zamba2-1.2b", None),
                         ("falcon-mamba-7b", FALCON_TRAIN_LAYERS)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        out[arch] = _train_run(dev, cfg, "train_ssm", card, TRAIN_SSM_STEPS)
        log(f"[time] train_ssm: {arch} {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------------ phase 8h
def _frontend_checks(dev, arch: str) -> dict:
    """At full width and FRONTEND_CHECK_LAYERS layers in fp32 compute: the
    prefill's logits through K2 against the chunked plain path's over the
    F frames and a FRONTEND_PROMPT-token prompt, and three decode steps
    after the K2 prefill against ``forward`` at the same positions; each
    max |d logits| over the reference logits' spread."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.params import init_params
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=FRONTEND_CHECK_LAYERS,
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(dev).manual_seed(4),
                         device=dev)
    rng = np.random.default_rng(4)
    S, nf, n = FRONTEND_PROMPT, cfg.frontend_tokens, 3
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S + n))
                            .astype(np.int32)).to(dev)
    fe = torch.from_numpy(rng.standard_normal((2, nf, cfg.d_model))
                          .astype(np.float32)).to(dev)
    with torch.inference_mode():
        full, _ = lm.forward(cfg, params, toks, fe)
        got, cache = lm.prefill(cfg, params, toks[:, :S], max_len=nf + S + n,
                                frontend_embeds=fe)
        want, _ = lm.prefill(cfg, params, toks[:, :S], impl="chunked",
                             frontend_embeds=fe)
        spread = float(want.max() - want.min())
        d_pre = float((got - want).abs().max()) / spread
        d_dec = []
        for i in range(n):
            step, cache = lm.decode_step(cfg, params, cache, toks[:, S + i])
            ref = full[:, nf + S + i]
            d_dec.append(float((step - ref).abs().max())
                         / float(ref.max() - ref.min()))
    del params, full, cache
    gc.collect()
    torch.cuda.empty_cache()
    tol = STEP_REL_TOL["float32"]
    log(f"[frontend] {arch} fp32, full width, {FRONTEND_CHECK_LAYERS} "
        f"layers, {nf} frames + {S} tokens: prefill K2 vs chunked "
        f"{d_pre:.3e} of the spread; decode after prefill vs forward "
        f"{', '.join(f'{d:.3e}' for d in d_dec)} (tol {tol})")
    if d_pre > tol or max(d_dec) > tol:
        raise SystemExit(f"frontend: {arch}'s prefill or decode disagrees "
                         "with the plain path")
    return {"prefill_rel": d_pre, "decode_rel": d_dec}


def phase_frontend(dev, card: str = "") -> dict:
    """The modality-frontend archs (seeded stub frames): the fp32 checks
    of :func:`_frontend_checks` for both; internvl2-1b at full width and
    depth trained TRAIN_SSM_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens
    behind its 256 frames; musicgen-large at full width and depth (bf16
    weights from a seeded ``torch.Generator``): 8 prompts of
    FRONTEND_PROMPT tokens behind its 64 frames prefilled through K2, then
    FRONTEND_NEW greedy ``decode_step``s (FRONTEND_NEW + 1 tokens a
    prompt). Returns the summaries and K2's
    launches in the musicgen run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.params import init_params
    out = {arch: _frontend_checks(dev, arch)
           for arch in ("internvl2-1b", "musicgen-large")}
    t0 = time.perf_counter()
    out["internvl2-1b"].update(_train_run(
        dev, get_config("internvl2-1b"), "frontend", card, TRAIN_SSM_STEPS))
    log(f"[time] frontend: internvl2-1b training "
        f"{time.perf_counter() - t0:.1f}s")

    cfg = get_config("musicgen-large")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(6),
                         device=dev)
    rng = np.random.default_rng(6)
    B, S, nf = 8, FRONTEND_PROMPT, cfg.frontend_tokens
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32)).to(dev)
    fe = torch.from_numpy(rng.standard_normal((B, nf, cfg.d_model))
                          .astype(np.float32)).to(dev)
    layers = lm.layer_views(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cfg, params, toks,
                                   max_len=nf + S + FRONTEND_NEW,
                                   frontend_embeds=fe, layers=layers)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        tok = torch.argmax(logits, dim=-1)
        outs = [tok]
        t0 = time.perf_counter()
        for _ in range(FRONTEND_NEW):
            logits, cache = lm.decode_step(cfg, params, cache, tok,
                                           layers=layers)
            tok = torch.argmax(logits, dim=-1)
            outs.append(tok)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    gen = torch.stack(outs, dim=1).cpu()
    ok = bool(torch.isfinite(logits).all()) and int(cache["pos"]) \
        == nf + S + FRONTEND_NEW and bool(
            (gen < cfg.vocab_size).all() and (gen >= 0).all())
    log(f"[frontend] {card} | musicgen-large full width and depth "
        f"({cfg.num_layers} layers, {cfg.param_count() / 1e9:.3f} B params, "
        f"bf16, init {init_s:.1f}s): prefill of {B} x ({nf} frames + {S} "
        f"tokens) {1e3 * pre_s:.2f} ms; {FRONTEND_NEW} decode steps "
        f"{1e3 * dec_s / FRONTEND_NEW:.2f} ms a step "
        f"({B * FRONTEND_NEW / dec_s:.1f} tok/s); launches {counts}; "
        f"first row's tokens {gen[0].tolist()}")
    if not ok or counts["flash_attention"] != cfg.num_layers:
        raise SystemExit("frontend: musicgen-large's prefill and decode "
                         f"failed (finite, in-vocab, pos; K2 {counts})")
    del params, cache, layers, logits
    gc.collect()
    torch.cuda.empty_cache()
    out["musicgen-large"].update(prefill_ms=1e3 * pre_s,
                                 decode_ms=1e3 * dec_s / FRONTEND_NEW,
                                 counts=counts)
    return out

# ------------------------------------------------------------------ phase 9
def _build_ablations(source: str, table: dict, other=None) -> dict:
    """Start one nvcc per altered copy of ``csrc/<source>`` (in parallel,
    into build/kernels/ablation/<stem>/<name>/); ``table`` maps each name
    to its (anchor, replacement) edits. ``other``, a directory of another
    tree's kernel sources (e.g. the parent commit's ``csrc``), adds its
    ``source`` unaltered as the build ``other``. Returns {name: (dir,
    process)}."""
    from repro_torch.kernels._build import BUILD_ROOT, CSRC, NVCC_FLAGS, _nvcc
    builds = {name: (CSRC, cuts) for name, cuts in table.items()}
    if other is not None:
        builds["other"] = (Path(other), [])
    procs = {}
    for name, (csrc, cuts) in builds.items():
        text = (csrc / source).read_text()
        for anchor, repl in cuts:
            if anchor not in text:
                raise SystemExit(f"ablation {name}: {anchor!r} is no "
                                 f"longer in {source}")
            text = text.replace(anchor, repl)
        d = BUILD_ROOT / "ablation" / Path(source).stem / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(text)
        (d / "common.cuh").write_text((csrc / "common.cuh").read_text())
        procs[name] = (d, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _time_ablations(procs, entry: str, args, own, init=None,
                    timer=time_ms, args_of=None, libs=None,
                    logs=None) -> dict:
    """Time each build's C entry point ``entry`` on ``args`` (or on
    ``args_of[name]``) and the current stream (after its ``init`` entry,
    where the build has one) beside ``own``, the kernel through its
    wrapper, with ``timer``, in turns: own, the builds, the builds
    backwards, own. ``libs`` and ``logs`` receive each build's loaded
    library and compiler output. Returns {name: [ms, ms]}, own's times
    under "kernel"."""
    import ctypes

    from repro_torch.kernels._build import _SIGNATURES, current_stream
    idx = torch.cuda.current_device()
    calls = {"kernel": own}
    for name, (d, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"ablation {name} does not build:\n{text}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        if logs is not None:
            logs[name] = text
        if libs is not None:
            libs[name] = lib
        fn = getattr(lib, entry)
        args_ = (args_of or {}).get(name, args)
        fn.argtypes = list(_SIGNATURES[entry])
        fn.restype = ctypes.c_int
        if init is not None and hasattr(lib, init):
            getattr(lib, init).restype = ctypes.c_int
            if getattr(lib, init)() != 0:
                raise SystemExit(f"ablation {name}: {init} failed")
        if fn(*args_, current_stream(idx)) != 0:
            raise SystemExit(f"ablation {name} does not launch")
        calls[name] = lambda fn=fn, a=args_: fn(*a, current_stream(idx))
    times = {name: [] for name in calls}
    for name in [*calls, *reversed(calls)]:
        times[name].append(timer(calls[name]))
    return times


def _turns(times: dict) -> str:
    return " | ".join(f"{n} {min(t):.5f}-{max(t):.5f} ms"
                      for n, t in times.items())


def phase_k4(dev):
    from repro_torch.bench.fig13_lsdnn import make_hpec
    from repro_torch.kernels import lsdnn_layer as lsdnn_mod
    from repro_torch.kernels.ref import lsdnn_layer_ref
    ablations = _build_ablations("lsdnn_layer.cu", K4_ABLATIONS)
    # (they build while the checks run)
    g = torch.Generator(dev).manual_seed(4)

    def normal(T, F, G, dtype):
        y = torch.randn((T, F), generator=g, device=dev)
        w = torch.randn((F, G), generator=g, device=dev) * 0.05
        b = torch.randn((G,), generator=g, device=dev)
        return y.to(dtype), w.to(dtype), b.to(dtype)

    net = make_hpec(layers=1, rows=LSDNN_ROWS, seed=1)
    hpec = tuple(torch.from_numpy(a).to(dev)
                 for a in (net.y0, net.ws[0], net.b))
    ones = (torch.full((64, 64), 10.0, device=dev),
            torch.ones((64, 64), device=dev), torch.zeros(64, device=dev))
    cases = [("HPEC shape, normal", normal(LSDNN_ROWS, 1024, 1024, F32)),
             ("HPEC shape, normal", normal(LSDNN_ROWS, 1024, 1024, BF16)),
             ("HPEC layer 0, binary rows", hpec),
             ("ragged T and G", normal(1000, 1024, 1000, F32)),
             ("ragged T and G", normal(1000, 1024, 1000, BF16)),
             ("F, G not multiples of 4", normal(999, 130, 257, F32)),
             ("cap-saturating", ones),
             ("cap-saturating", tuple(t.to(BF16) for t in ones))]
    errs = []
    for what, (y, w, b) in cases:
        out = lsdnn_mod.lsdnn_layer_cuda(y, w, b, cap=LSDNN_CAP)
        ref = lsdnn_layer_ref(y, w, b, cap=LSDNN_CAP)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = K4_TOL[y.dtype]
        log(f"[k4] {what} T={y.shape[0]} F={y.shape[1]} G={w.shape[1]} "
            f"{str(y.dtype)[6:]}: max|kernel-plain|={err:.3e} (tol {tol}), "
            f"max {out.float().max().item():.4g}")
        if not torch.isfinite(out.float()).all().item() or err > tol:
            raise SystemExit(f"K4 disagrees with its plain version: {err}")
        if what == "cap-saturating" and out.float().max().item() != LSDNN_CAP:
            raise SystemExit("K4 did not clamp at the cap")
        errs.append(err)
    # timing at the HPEC shape on dense normal data (the kernel's work does
    # not depend on the data: it multiplies the dense form)
    y, w, b = cases[0][1]
    T, Fd = y.shape
    G = w.shape[1]
    ms = time_ms(lambda: lsdnn_mod.lsdnn_layer_cuda(y, w, b), iters=20)
    plain_ms = time_ms(lambda: lsdnn_layer_ref(y, w, b), iters=10)
    lib_ms = time_ms(lambda: torch.addmm(b, y, w).clamp_(0.0, LSDNN_CAP),
                     iters=20)
    nbytes = 4 * (T * Fd + Fd * G + G + T * G)
    flops = 2.0 * T * Fd * G
    b_ms, b_by = bound_ms(nbytes, flops, FP32_FLOPS_PER_S)
    hy, hw, hb = hpec
    hpec_ms = time_ms(lambda: lsdnn_mod.lsdnn_layer_cuda(hy, hw, hb),
                      iters=20)
    sass = sass_counts("lsdnn_layer")
    if not sass or any(c["HMMA"] or not c["FFMA"] for c in sass.values()) \
            or not any(c["LDGSTS"] for c in sass.values()):
        raise SystemExit(f"K4's SASS: want FFMA and cp.async, no HMMA: "
                         f"{sass}")
    log(f"[k4] timing T={T} F=G={Fd} fp32: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s) | plain {plain_ms:.4f} ms | "
        f"torch.addmm + clamp_ (two calls, TF32 off) {lib_ms:.4f} ms | "
        f"bound {b_ms:.4f} ms ({b_by}; fp32 non-tensor peak "
        f"{FP32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; {nbytes} B, {flops:.3e} "
        f"flop) | on the HPEC layer (binary rows, 3% of W nonzero) "
        f"{hpec_ms:.4f} ms")
    kernel_report("[k4]", "lsdnn_layer", flops, ms, b_ms, lib_ms, sass)
    out = torch.empty((T, G), device=dev)
    cut = _time_ablations(
        ablations, "repro_lsdnn_layer",
        (0, y.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), T, Fd,
         G, LSDNN_CAP), lambda: lsdnn_mod.lsdnn_layer_cuda(y, w, b),
        "repro_lsdnn_layer_init", timer=lambda fn: time_ms(fn, iters=20))
    log(f"[k4] ablation (same shape, parts of the work cut out; in turns): "
        f"{_turns(cut)}")
    return dict(name="lsdnn_layer", route="cuda",
                source="src/repro_torch/kernels/csrc/lsdnn_layer.cu",
                replaces="src/repro/kernels/lsdnn_layer.py:24",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


# ------------------------------------------------------------------ phase 10
def phase_lsdnn(dev) -> int:
    from repro_torch.bench import fig13_lsdnn as fb
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    net = fb.make_hpec(rows=LSDNN_ROWS, seed=0)
    layers, rows = len(net.ws), net.y0.shape[0]
    log(f"[lsdnn] HPEC network: {layers} layers x {net.y0.shape[1]} neurons,"
        f" {rows} rows, {fb.HPEC_NNZ} weights of 1/16 per neuron, bias "
        f"{fb.HPEC_BIAS}, cap {net.cap}; {LSDNN_PASSES} chained passes, "
        f"{LSDNN_BLOCK} layers per captured op; made in "
        f"{time.perf_counter() - t0:.1f}s")
    ops.reset_launch_counts()
    res = fb.run_paths(net, LSDNN_PASSES, LSDNN_BLOCK, dev)
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    plain = fb.plain_output(net, LSDNN_PASSES, dev)
    plain_s = time.perf_counter() - t0
    for name, r in res.items():
        log(f"[lsdnn] {name}: {r.ms:.1f} ms, {r.calls} host launches, "
            f"{r.kernel_launches} K4 launches on the device, tasks "
            f"{r.tasks}, peak device {r.peak_device_mb:.0f} MiB above the "
            f"path's start, process peak RSS {r.peak_rss_mb:.0f} MiB "
            f"{r.graph or ''}")
    ref = res["sequential"]
    cats = fb.categories(ref.y)
    for name, r in res.items():
        err = float(np.abs(r.y - ref.y).max())
        if not np.isfinite(r.y).all() or err > K4_TOL[F32]:
            raise SystemExit(f"lsdnn {name} disagrees with sequential: {err}")
        if not np.array_equal(fb.categories(r.y), cats):
            raise SystemExit(f"lsdnn {name}: categories differ")
    plain_cats = fb.categories(plain)
    diff = np.abs(plain - ref.y)
    log(f"[lsdnn] categories: {len(cats)} of {rows} rows active, identical "
        f"across the three paths; plain version ({plain_s:.1f}s): "
        f"{len(plain_cats)} rows, identical={np.array_equal(plain_cats, cats)}"
        f"; max|kernel-plain| {diff.max():.3e} over {int((diff > 0).sum())} "
        f"differing outputs; output max {ref.y.max():.4g}")
    if not np.array_equal(plain_cats, cats):
        raise SystemExit("lsdnn: categories differ from the plain version")
    if not 0 < len(cats) < rows:
        raise SystemExit(f"lsdnn: {len(cats)} of {rows} rows active")
    if res["taskflow"].calls != LSDNN_PASSES:
        raise SystemExit(f"taskflow launches {res['taskflow'].calls} != "
                         f"{LSDNN_PASSES} passes")
    k4 = sum(r.kernel_launches for r in res.values())
    wrapper = res["sequential"].kernel_launches \
        + res["unrolled"].kernel_launches + res["taskflow"].graph["wrapper_k4"]
    if counts["lsdnn_layer"] != wrapper:
        raise SystemExit(f"K4 wrapper count {counts['lsdnn_layer']} != the "
                         f"paths' {wrapper}")
    if k4 < 3 * layers * LSDNN_PASSES:
        raise SystemExit(f"K4 device launches {k4} < 3 x {layers} x "
                         f"{LSDNN_PASSES}")
    log(f"[lsdnn] K4 launches: {counts['lsdnn_layer']} wrapper calls, {k4} "
        f"on the device (eager calls + {res['taskflow'].graph['captured_k4']}"
        f" captured x {res['taskflow'].graph['replays']} replays)")
    print(json.dumps({"lsdnn": {n: v for n, v, _ in fb.rows_of(res)}}),
          flush=True)
    return k4


# ------------------------------------------------------------------ phase 11
def phase_device_task(dev) -> None:
    from repro_torch.core import ACCEL, HOST, DeviceFlow, Executor, Taskflow
    n = 1 << 16
    x = np.ones(n, np.float32)
    y = np.full(n, 2.0, np.float32)
    got = {}

    def saxpy(df: DeviceFlow):
        df.copy("x", x).copy("y", y)
        df.kernel(lambda x, y: 2.0 * x + y, ["x", "y"], ["z"])
        df.fetch("z")
        got["df"] = df

    ex = Executor(domains={HOST: 1, ACCEL: 1}, devices={ACCEL: [dev]})
    try:
        tf = Taskflow("saxpy")
        t = tf.device(saxpy)
        check = tf.static(lambda: got.__setitem__("z", got["df"].result("z")))
        t.precede(check)
        ex.run(tf).wait()
    finally:
        ex.shutdown()
    df = got["df"]
    ok = np.array_equal(got["z"], 2.0 * x + y)
    log(f"[device] DEVICE task saxpy n={n} on {df.device}: one CUDA-graph "
        f"replay (num_launches={df.num_launches}), equal to numpy: {ok}")
    if not ok or df.num_launches != 1:
        raise SystemExit("DEVICE task saxpy failed")


# the row names each suite of the quick bench pass must write
BENCH_ROWS = {
    "table2": ["table2/S_task_bytes", "table2/T_task_ns", "table2/T_edge_ns",
               "rho_<10%_work_us", "rho_<5%_work_us", "rho_<1%_work_us"],
    "fig9": [f"fig9/n{n}/{m}" for n in (1000, 5000) for m in (
        "sequential_ms", "levelized_ms", "futures_ms", "taskflow_ms",
        "taskflow_tasks_per_s", "steals_ok", "sleep_residency")]
    + ["fig9/peak_rss_mb", "fig9/host_cores"],
    "fig17": [f"fig17/host/{f}_k{k}_{m}" for k in (8, 64, 512)
              for f in ("cyclic", "unrolled") for m in ("tasks", "bytes")]
    + [f"fig17/cuda/{f}_nodes_k{k}" for f in ("while", "unrolled")
       for k in (8, 256)]
    + ["fig17/cuda/node_ratio", "fig17/cuda/host_loop_ms"]
    + [f"fig17/cuda/{f}_{m}" for f in ("while", "unrolled")
       for m in ("capture_ms", "replay_ms", "pool_bytes")],
    "paged_decode": [f"{p}_read_{o}_occ_ms" for p in ("paged", "plain",
                                                      "gather")
                     for o in ("low", "mid", "full")]
    + ["decode_step_paged_low_occ_ms", "decode_step_gather_low_occ_ms",
       "paged_read_kernel_launches"],
}
FIG17_K, FIG17_N = 256, 256


def phase_condgraph(dev, card: str) -> dict:
    """CondGraph's programs against lower() on the card and the CPU,
    fig17's device panel, and the quick bench pass. Returns the
    ``cond_graph`` entry of the kernels line and K1's launches in the
    paged_decode sweep (``"k1_sweep"``)."""
    from repro_torch.bench import condgraph_check, fig17_conditional_memory
    from repro_torch.bench import run as bench_run
    from repro_torch.kernels import cond_graph, ops

    t0 = time.perf_counter()
    log(f"[condgraph] CUDA versions {cond_graph.versions(dev.index)}")
    cond_graph.launches = 0
    rep = condgraph_check.check_device(dev, FIG17_K, FIG17_N, log=log)
    p = fig17_conditional_memory.device_panel(dev, FIG17_K, FIG17_N)
    launches = cond_graph.launches
    log(f"[condgraph] {len(rep['programs'])} programs equal to lower() on "
        f"the card and the CPU (largest error {rep['max_abs_err']:.3g}), "
        f"one launch per call, no host sync ({time.perf_counter() - t0:.1f}"
        "s)")
    log(f"[condgraph] fig17 (x {FIG17_N}x{FIG17_N} fp32 ones, x <- x @ x * "
        f"0.5, TF32 off) on {card}: nodes WHILE k=8 "
        f"{p['while_nodes_k8']}, k={FIG17_K} {p[f'while_nodes_k{FIG17_K}']}"
        f" | unrolled k=8 {p['unrolled_nodes_k8']}, k={FIG17_K} "
        f"{p[f'unrolled_nodes_k{FIG17_K}']}")
    log(f"[condgraph] fig17 k={FIG17_K}: WHILE capture "
        f"{p['while_capture_ms']:.3f} ms, call {p['while_replay_ms']:.4f} "
        f"ms, pool {p['while_pool_bytes']} B | unrolled capture "
        f"{p['unrolled_capture_ms']:.3f} ms, call "
        f"{p['unrolled_replay_ms']:.4f} ms, pool {p['unrolled_pool_bytes']}"
        f" B | host loop {p['host_loop_ms']:.3f} ms | WHILE without the "
        f"matmul ({p['while_count_only_nodes']} nodes) "
        f"{p['while_count_only_ms']:.4f} ms")
    if p[f"while_nodes_k{FIG17_K}"] != p["while_nodes_k8"] or             p[f"unrolled_nodes_k{FIG17_K}"] <= p["unrolled_nodes_k8"]:
        raise SystemExit("condgraph: the WHILE program's nodes grew with k, "
                         "or the unrolled graph's did not")
    if p["while_iters"] != FIG17_K:
        raise SystemExit(f"condgraph: the fig17 program ran "
                         f"{p['while_iters']} iterations, not {FIG17_K}")

    out_dir = Path(__file__).resolve().parent / "build" / "bench"
    suites = ",".join(BENCH_ROWS)
    t1 = time.perf_counter()
    before = ops.launch_counts()["paged_attention"]
    rc = bench_run.main(["--only", suites, "--quick", "--bench-dir",
                         str(out_dir)])
    k1_sweep = ops.launch_counts()["paged_attention"] - before
    if rc != 0:
        raise SystemExit(f"condgraph: bench.run --only {suites} failed")
    for suite, names in BENCH_ROWS.items():
        data = json.loads((out_dir / f"BENCH_{suite}.json").read_text())
        got = {r["name"] for r in data["rows"]}
        missing = [n for n in names if n not in got]
        if missing or data["suite"] != suite or not {
                "config", "git_sha", "timestamp", "timestamp_iso",
                "elapsed_s", "metrics"} <= set(data):
            raise SystemExit(f"condgraph: BENCH_{suite}.json lacks "
                             f"{missing or 'schema keys'}")
    if k1_sweep <= 0:
        raise SystemExit("condgraph: the paged_decode sweep launched no K1")
    log(f"[condgraph] bench.run --only {suites} --quick: every BENCH_*.json "
        f"holds its rows; K1 launched {k1_sweep} times in the sweep "
        f"({time.perf_counter() - t1:.1f}s)")
    # the bound: k times the body matmul's (x @ x, fp32 on the CUDA cores)
    n = FIG17_N
    b_ms, b_by = bound_ms(3 * n * n * 4, 2.0 * n ** 3, FP32_FLOPS_PER_S)
    return {"name": "cond_graph", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cond_graph.cu",
            "replaces": "src/repro/core/jaxgraph.py:274",
            "launches": launches, "max_abs_err": rep["max_abs_err"],
            "ms": p["while_replay_ms"], "plain_ms": p["host_loop_ms"],
            "bound_ms": FIG17_K * b_ms, "bound_by": b_by,
            "library_ms": p["unrolled_replay_ms"], "k1_sweep": k1_sweep}


# ------------------------------------------------------------------ 11b-d
def phase_examples(dev, card: str, extra=()) -> dict:
    """The five examples on the card at their default sizes (train_lm cut
    to 20 steps; ``extra`` arguments go to each, e.g. ``--device cpu`` for
    a rehearsal); returns the kernels' launches in them."""
    from repro_torch.examples import (lsdnn_inference, placement_loop,
                                      quickstart, serve_lm, train_lm)
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t = {}
    t0 = time.perf_counter()
    quickstart.main([*extra])
    t["quickstart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pl = placement_loop.main([*extra])
    t["placement_loop"] = time.perf_counter() - t0
    h = pl["history"]
    if not (pl["iterations"] >= 1 and np.isfinite(h).all() and h[-1] < h[0]):
        raise SystemExit(f"[examples] placement_loop: history {h[:3]}..."
                         f"{h[-3:]} over {pl['iterations']} iterations")
    t0 = time.perf_counter()
    sv = serve_lm.main([*extra])
    t["serve_lm"] = time.perf_counter() - t0
    if [len(o) for o in sv["burst"]] != [48] * 8 or \
            "pump" not in sv["mixed_kinds"]:
        raise SystemExit("[examples] serve_lm: bad burst or stage log")
    t0 = time.perf_counter()
    tr = train_lm.main(["--steps", "20", *extra])
    t["train_lm"] = time.perf_counter() - t0
    losses = [x["loss"] for x in tr["history"]]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and len(tr["sample"]) == 16):
        raise SystemExit(f"[examples] train_lm: losses {losses}")
    t0 = time.perf_counter()
    rows = {r[0]: r[1] for r in lsdnn_inference.main([*extra])}
    t["lsdnn_inference"] = time.perf_counter() - t0
    ref = [f"fig13/{k}" for k in (
        "sequential_ms", "sequential_launches", "unrolled_ms",
        "unrolled_launches", "unrolled_tasks", "taskflow_ms",
        "taskflow_launches", "taskflow_tasks", "result_max_err",
        "peak_rss_mb")]
    missing = [k for k in ref if k not in rows]
    if missing or rows["fig13/result_max_err"] > 1e-3 \
            or rows["fig13/taskflow_kernel_launches"] <= 0:
        raise SystemExit(f"[examples] lsdnn_inference: missing {missing}, "
                         f"rows {rows}")
    counts = ops.launch_counts()
    for k in ("paged_attention", "flash_attention", "lsdnn_layer"):
        if counts[k] <= 0:
            raise SystemExit(f"[examples] no {k} launch")
    log(f"[examples] on {card}: seconds "
        f"{ {k: round(v, 2) for k, v in t.items()} }; placement "
        f"{pl['iterations']} iterations, wirelength {h[0]:.1f} -> "
        f"{h[-1]:.1f}; train_lm loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"lsdnn taskflow {rows['fig13/taskflow_ms']:.3f} ms, sequential "
        f"{rows['fig13/sequential_ms']:.3f} ms; launches {counts}")
    return counts


def phase_nested(dev) -> int:
    """A DeviceFlow nesting a compiled CondGraph; returns the conditional
    program's launches (its warm-up and its capture)."""
    from repro_torch.bench.condgraph_check import check_nested
    from repro_torch.kernels import cond_graph

    before = cond_graph.launches
    rep = check_nested(dev, d=NESTED_D, log=log)
    if rep["offloads"] != 3 or rep["program_launches"] != 2:
        raise SystemExit(f"[nested] {rep}")
    log(f"[nested] the program's nodes: {rep['nodes']}")
    return cond_graph.launches - before


def _mesh_serve(cfg, params, dev, prompts, tp=None) -> dict:
    """The 8 staggered requests through one engine (the 2-rank one with
    ``tp``): outputs, wall, rank 0's pool bytes, the mean decode cycle and
    rank 0's kernel launches over the engine's life, warm-up included (the
    window a follower counts, from OP_INIT to OP_STOP)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import Observability
    from repro_torch.serve.engine import ServeEngine

    obs = Observability()
    before = ops.launch_counts()
    with ServeEngine(cfg, params, decode_chunk=8, max_batch=8,
                     kv_blocks=128, block_size=16, device=dev, obs=obs,
                     tp=tp) as eng:
        eng.result(eng.submit(prompts[0][:8], max_new=2))   # warm-up
        torch.cuda.synchronize()
        obs.reset()
        if tp is not None:
            tp.reset_counters()
        t0 = time.perf_counter()
        reqs = []
        for p in prompts:
            reqs.append(eng.submit(p, max_new=MAX_NEW))
            time.sleep(0.02)
        outs = [eng.result(r, timeout=600.0) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pool = eng._pkv.numel() * eng._pkv.element_size()
        cyc = obs.metrics.get("engine.cycle_s").summary()
    after = ops.launch_counts()
    for o in outs:
        if o.shape != (MAX_NEW,) or not ((o >= 0) & (o < cfg.vocab_size)
                                         ).all():
            raise SystemExit(f"[mesh] bad output {o}")
    return {"outs": outs, "wall": wall, "pool": pool,
            "cycle_ms": 1e3 * cyc["mean"], "cycles": cyc["count"],
            "counts": {k: after[k] - before[k] for k in after},
            "counters": tp.counters() if tp is not None else None}


def _column_slice_check(cfg, params, dev, prompts, probe, single, mesh,
                        mesh_logits) -> dict:
    """The bf16 single-device engine on ``column_slice_params``: each
    product a rank holds a column slice of computed slice by slice, as the
    ranks do. Its tokens and prefill logits against the 2-rank run's and
    the single engine's. Equal to the 2-rank run's: the ranks' tokens
    differ from the single engine's by the shapes of their products, and
    the group adds nothing."""
    from repro_torch.bench.serve_mesh import column_slice_params
    from repro_torch.models import lm

    sliced = column_slice_params(cfg, params, MESH_RANKS)
    run = _mesh_serve(cfg, sliced, dev, prompts)
    with torch.inference_mode():
        sl_logits, _ = lm.prefill(cfg, sliced, probe.to(dev))
        one_logits, _ = lm.prefill(cfg, params, probe.to(dev))
    n = len(prompts) * MAX_NEW
    eq = {k: sum(int((a == b).sum()) for a, b in zip(run["outs"], o["outs"]))
          / n for k, o in (("mesh", mesh), ("single", single))}
    out = {"tokens_equal_mesh": eq["mesh"], "tokens_equal_single":
           eq["single"],
           "logits_equal_mesh": bool(torch.equal(sl_logits, mesh_logits)),
           "logits_max_diff_mesh": float((sl_logits - mesh_logits).abs()
                                         .max()),
           "single_logits_max_diff_mesh": float(
               (one_logits - mesh_logits).abs().max())}
    log(f"[mesh] bf16 column-slice single-device engine: "
        f"{100 * eq['mesh']:.2f}% of tokens equal to the 2-rank run's, "
        f"{100 * eq['single']:.2f}% to the single engine's; prefill logits "
        f"of a 64-token probe equal to the 2-rank run's: "
        f"{out['logits_equal_mesh']} (max |d| "
        f"{out['logits_max_diff_mesh']}), single engine's max |d| against "
        f"the 2-rank run's {out['single_logits_max_diff_mesh']}")
    return out


def phase_mesh(dev, card: str) -> dict:
    """stablelm-1.6b on 2 gloo ranks sharing the card against the
    single-device engine; returns the ranks' K1/K2 launches."""
    from repro_torch.bench.serve_mesh import FollowEach, probe_logits
    from repro_torch.launch.mesh import ModelSpec, TPSession
    from repro_torch.serve.tp import release_followers

    fp32 = ModelSpec("stablelm-1.6b", MESH_PRESET, 0, (
        ("compute_dtype", "float32"), ("num_layers", MESH_FP32_LAYERS)))
    bf16 = ModelSpec("stablelm-1.6b", MESH_PRESET, 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {"paged_attention": 0, "flash_attention": 0}
    res = {}
    t0 = time.perf_counter()
    probe_rows = tuple(tuple(int(t) for t in np.random.default_rng(5)
                             .integers(0, bf16.config().vocab_size, 64))
                       for _ in range(1))
    probe = torch.tensor(probe_rows, dtype=torch.int32)
    with TPSession(MESH_RANKS, "gloo", fp32, dev,
                   body=FollowEach((bf16,), probe=probe_rows),
                   timeout=600.0) as s:
        log(f"[mesh] {MESH_RANKS} gloo ranks on {dev} up in "
            f"{time.perf_counter() - t0:.1f}s")
        for tag, spec in (("fp32", fp32), ("bf16", bf16)):
            cfg, params = spec(dev)
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, cfg.vocab_size, size=n)
                       .astype(np.int32) for n in PROMPT_LENS]
            if tag == "bf16":   # the 2-rank prefill logits, both ranks
                mesh_logits = probe_logits(cfg, params, s.tp, probe)
            single = _mesh_serve(cfg, params, dev, prompts)
            mesh = _mesh_serve(cfg, params, dev, prompts, s.tp)
            if tag == "bf16":
                res["column_slices"] = _column_slice_check(
                    cfg, params, dev, prompts, probe, single, mesh,
                    mesh_logits)
            if tag == "fp32":
                release_followers(s.tp)       # the follower builds bf16
            for k in counts:
                counts[k] += mesh["counts"][k]
            c = mesh["counters"]
            if c["calls"].get("all_reduce", 0) or \
                    c["calls"].get("all_gather:chunk", 0) == 0 or \
                    2 * c["max_bytes"]["all_gather:chunk"] >= mesh["pool"]:
                raise SystemExit(f"[mesh] {tag}: collectives {c} against a "
                                 f"pool shard of {mesh['pool']} B")
            if 2 * mesh["pool"] != single["pool"]:
                raise SystemExit(f"[mesh] {tag}: rank 0's pool "
                                 f"{mesh['pool']} B, single {single['pool']}")
            same = [np.array_equal(a, b)
                    for a, b in zip(single["outs"], mesh["outs"])]
            tok_eq = sum(int((a == b).sum()) for a, b in
                         zip(single["outs"], mesh["outs"]))
            share = tok_eq / (len(prompts) * MAX_NEW)
            flip = ""
            if not all(same):
                i = same.index(False)
                flip = "; first flip: request " + str(i) + ", " + \
                    _first_flip_margin(cfg, params, prompts[i],
                                       single["outs"][i], mesh["outs"][i],
                                       dev)
            if tag == "fp32" and not all(same):
                raise SystemExit(f"[mesh] fp32 at {MESH_FP32_LAYERS} layers: "
                                 f"tokens differ from the single-device "
                                 f"engine{flip}")
            ntok = len(prompts) * MAX_NEW
            res[tag] = {"equal_share": share,
                        "mesh_tok_s": ntok / mesh["wall"],
                        "single_tok_s": ntok / single["wall"],
                        "mesh_cycle_ms": mesh["cycle_ms"],
                        "single_cycle_ms": single["cycle_ms"],
                        "pool_rank_bytes": mesh["pool"],
                        "pool_single_bytes": single["pool"],
                        "all_gathers": c["calls"].get("all_gather", 0),
                        "chunk_max_gather_bytes":
                            c["max_bytes"]["all_gather:chunk"]}
            log(f"[mesh] {tag} ({cfg.num_layers} layers, {cfg.compute_dtype}"
                f") on {card}, host-staged gloo, one card shared by "
                f"{MESH_RANKS} ranks (not a tensor-parallel speed): "
                f"{sum(same)}/{len(same)} requests and {100 * share:.2f}% of "
                f"tokens equal to the single-device engine{flip}; mesh "
                f"{res[tag]['mesh_tok_s']:.1f} tok/s, cycle "
                f"{mesh['cycle_ms']:.2f} ms over {mesh['cycles']} cycles | "
                f"single {res[tag]['single_tok_s']:.1f} tok/s, cycle "
                f"{single['cycle_ms']:.2f} ms; pool {mesh['pool']} B a rank "
                f"vs {single['pool']} B; collectives {c['calls']}, largest "
                f"chunk all-gather {c['max_bytes']['all_gather:chunk']} B; "
                f"rank 0 launches {mesh['counts']}")
            del params
            gc.collect()
            torch.cuda.empty_cache()
    (fol,) = s.followers
    res["column_slices"]["allow_bf16_reduced_precision_reduction"] = {
        "rank0": torch.backends.cuda.matmul
        .allow_bf16_reduced_precision_reduction,
        "rank1": fol["result"]["allow_bf16_reduced_precision_reduction"]}
    log(f"[mesh] allow_bf16_reduced_precision_reduction: "
        f"{res['column_slices']['allow_bf16_reduced_precision_reduction']} "
        "(the single-device and column-slice engines run on rank 0)")
    engines = [e for model in fol["result"]["engines"] for e in model]
    fcounts = {k: sum(e["launches"].get(k, 0) for e in engines)
               for k in counts}
    for k in counts:
        counts[k] += fcounts[k]
    pools = [e["pool_bytes"] for e in engines]
    if fcounts["paged_attention"] <= 0 or fcounts["flash_attention"] <= 0:
        raise SystemExit(f"[mesh] the follower launched {fcounts}")
    log(f"[mesh] follower: {len(engines)} engines, ops "
        f"{[e['ops'] for e in engines]}, pool bytes {pools}, "
        f"launches {fcounts}, collectives {fol['counters']['calls']}")
    print(json.dumps({"mesh": res}), flush=True)
    return counts


# ------------------------------------------------------------------ phase 11e
def _sharded_leaf_bytes(shapes_specs, mesh) -> int:
    """What a rank of ``mesh`` (data, model) must hold: each leaf's fp32
    masters over the ranks its spec shards it across, the rest whole."""
    sizes = {"data": mesh[0], "model": mesh[1]}
    total = 0
    for shape, spec in shapes_specs:
        n = 4
        for k in shape:
            n *= k
        for e in spec:
            for a in (e if isinstance(e, (tuple, list)) else (e,)) if e \
                    else ():
                n //= sizes[a]
        total += n
    return total


def _train_mesh_runs() -> tuple:
    """The train_mesh phase's runs on its TRAIN_MESH_RANKS ranks: fp32,
    bf16 unhoisted and hoisted, falcon-mamba, then the (1, 2) runs."""
    from repro_torch.bench.train_mesh import TrainRun
    pre, seq = TRAIN_MESH_PRESET, TRAIN_MESH_SEQ
    fp32 = TrainRun("fp32", preset=pre, overrides=(
        ("compute_dtype", "float32"), ("num_layers", TRAIN_MESH_FP32_LAYERS)),
        batch=2, seq=seq, steps=1, keep=True)
    bf16 = [TrainRun(f"bf16-hoist{int(h)}", preset=pre, overrides=(
        ("hoist_weight_gather", h),) + ((("num_layers", TRAIN_MESH_BF16_LAYERS),)
                                         if TRAIN_MESH_BF16_LAYERS else ()),
        batch=4, seq=seq, steps=TRAIN_MESH_STEPS, lr=3e-4)
        for h in (False, True)]
    falcon = TrainRun("falcon-mamba", "falcon-mamba-7b", pre, (
        ("num_layers", TRAIN_MESH_FALCON_DP_LAYERS),), batch=2, seq=seq,
        steps=1, lr=3e-4)
    # (1, 2): the products partitioned over the model axis; fp32 in one
    # microbatch of 2 rows, the single-device step the (2, 1) fp32 run's
    fp32_tp = dataclasses.replace(fp32, name="fp32-tp", microbatches=1,
                                  mesh=(1, 2))
    falcon_tp = dataclasses.replace(
        falcon, name="falcon-mamba-tp", mesh=(1, 2),
        overrides=(("num_layers", TRAIN_MESH_FALCON_LAYERS),))
    # qwen2-moe on (1, 2): each rank's experts; its fp32 state is held
    # block by block against the single-device step's on the card, as
    # gathering 21 GB of it through the host would take minutes
    moe = (("num_layers", TRAIN_MESH_MOE_LAYERS),)
    moe_tp = TrainRun("moe-tp", "qwen2-moe-a2.7b", pre, moe + (
        ("compute_dtype", "float32"),), batch=2, seq=seq, steps=1,
        microbatches=1, mesh=(1, 2), vs_single=True)
    moe_bf16 = TrainRun("moe-tp-bf16", "qwen2-moe-a2.7b", pre, moe,
                        batch=2, seq=seq, steps=TRAIN_MESH_STEPS,
                        microbatches=1, mesh=(1, 2), lr=3e-4)
    # zamba2 on (1, 2): each rank's 32 SSD heads, the shared block's
    # fused_proj output gathered, held block by block like moe-tp
    zamba2_tp = TrainRun("zamba2-tp", "zamba2-1.2b", pre, (
        ("num_layers", TRAIN_MESH_ZAMBA2_LAYERS),
        ("compute_dtype", "float32")), batch=2, seq=seq, steps=1,
        microbatches=1, mesh=(1, 2), vs_single=True)
    return (fp32, *bf16, falcon, fp32_tp, falcon_tp, moe_tp, moe_bf16,
            zamba2_tp)


def _train_mesh_vlm_runs() -> tuple:
    """The train_mesh phase's run on TRAIN_MESH_VLM_RANKS ranks:
    internvl2-1b on (1, 4), held block by block against one device."""
    from repro_torch.bench.train_mesh import TrainRun
    return (TrainRun("internvl2-tp", "internvl2-1b", TRAIN_MESH_PRESET, (
        ("num_layers", TRAIN_MESH_VLM_LAYERS),
        ("compute_dtype", "float32")), batch=2, seq=TRAIN_MESH_SEQ, steps=1,
        microbatches=1, mesh=(1, TRAIN_MESH_VLM_RANKS), vs_single=True),)


def _serve_mesh_runs() -> tuple:
    """The partitioned serve steps' runs in train_mesh's session
    (SERVE_MESH_*)."""
    from repro_torch.bench.train_mesh import ServeRun
    pre, n = TRAIN_MESH_PRESET, SERVE_MESH_SHORT_STEPS
    fp32 = (("compute_dtype", "float32"),
            ("num_layers", SERVE_MESH_FP32_LAYERS))
    return (ServeRun("serve-fp32-tp", preset=pre, overrides=fp32, batch=2,
                     prompt=512, max_len=1024, steps=SERVE_MESH_STEPS),
            ServeRun("serve-bf16-tp", preset=pre, batch=2, prompt=2048,
                     max_len=4096, steps=n),
            ServeRun("serve-falcon-tp", "falcon-mamba-7b", pre, (
                ("compute_dtype", "float32"),
                ("num_layers", SERVE_MESH_FALCON_LAYERS)), batch=2,
                prompt=512, max_len=1024, steps=n),
            ServeRun("serve-b1", preset=pre, overrides=fp32, batch=1,
                     prompt=512, max_len=1024, steps=n, mesh=(2, 1),
                     serve_tp_only=True))


def _serve_kernel_shapes(run) -> dict:
    """The shapes a rank's K2 and K3 launches take in ``run``'s prefill:
    its rows, the prompt, its heads (all of them where attention runs
    whole) and its ``dI / tp`` channels."""
    from repro_torch.distributed.sharding import tp_whole
    cfg = run.config()
    d, m = run.mesh
    rows = run.batch // d if run.batch > 1 and run.batch % d == 0 \
        else run.batch
    whole = tp_whole(cfg, m) if m > 1 else {}

    def ranks(kind):
        return 1 if m == 1 or kind in whole else m
    out = {}
    if not cfg.attention_free:
        n = ranks("attn")
        out["K2"] = (rows, run.prompt, cfg.num_heads // n,
                     cfg.num_kv_heads // n, cfg.hd)
    if cfg.ssm and cfg.ssm_version == 1:
        n = ranks("mamba")
        out["K3"] = (rows, run.prompt, cfg.d_inner // n, cfg.ssm_state)
    return out


def _kernels_at_serve_shapes(runs, dev, card: str) -> dict:
    """K2 and K3 against their plain versions at the shapes the serve
    runs give them on a rank (:func:`_serve_kernel_shapes`), in the run's
    compute dtype, with phase_kernels' and phase_k3's tolerances: the
    ranks' runs are held to one device's, which launches the same kernels,
    so this and the plain path's run (:func:`_check_serve_tp`) are what
    holds the kernels to their plain versions at these shapes."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import mamba_scan as scan_mod
    from repro_torch.kernels.ref import flash_attention_ref, mamba_scan_ref
    g = torch.Generator(dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    out = {}
    for run in runs:
        dtype = getattr(torch, run.config().compute_dtype)
        for name, shape in _serve_kernel_shapes(run).items():
            key = f"{name} {shape} {str(dtype)[6:]}"
            if key in out:
                continue
            if name == "K2":
                B, S, H, KV, hd = shape
                q = randn(B, S, H, hd).to(dtype)
                k, v = (randn(B, S, KV, hd).to(dtype) for _ in range(2))
                got = flash_mod.flash_attention_cuda(q, k, v)
                want = flash_attention_ref(q, k, v)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = KERNEL_TOL
            else:
                B, S, dI, N = shape
                dt = F.softplus(randn(B, S, dI)) * 0.1
                x = randn(B, S, dI).to(dtype)
                Bc, Cc = (randn(B, S, N).to(dtype) for _ in range(2))
                A = -torch.exp(randn(dI, N) * 0.5)
                y, hT = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A)
                yr, hr = mamba_scan_ref(dt, A, Bc, Cc, x)
                torch.cuda.synchronize()
                got = torch.cat([y.flatten(), hT.flatten()])
                err, tol = max(_rel(y, yr), _rel(hT, hr)), K3_REL_TOL
            ok = bool(torch.isfinite(got.float()).all().item())
            what = "max|kernel-plain|" + ("" if name == "K2"
                                          else "/max(1,|plain|)")
            log(f"[serve_tp] {key} (a rank's in {run.name}) on {card}: "
                f"{what} = {err:.3e} (tol {tol})")
            if not ok or err > tol:
                raise SystemExit(f"[serve_tp] {key}: the kernel disagrees "
                                 f"with its plain version ({err} > {tol})")
            out[key] = err
    return out


def _check_serve_tp(runs, per_run, dev, card: str) -> dict:
    """The serve runs' checks: every rank's tokens for the same rows are
    the same; fp32 tokens are one device's and the logits of each step
    within LOGIT_TOL of its; against the plain path on one device (no
    hand-written kernel), fp32 tokens equal, the logits of each step
    within LOGIT_TOL and rank 0's block of the final cache within
    STATE_TOL of max(1, |plain|), and bf16 prefill logits within
    STEP_REL_TOL of the plain ones' spread (phase_steps' K2-vs-plain
    bound);
    K2 and K3 against their plain versions at the ranks' shapes
    (:func:`_kernels_at_serve_shapes`); a rank's KV bytes are one device's
    over the sequence-parallel ranks (every KV head at max_len / 2
    positions); on (1, 2) no leaf is all-gathered (the prefill gathers
    its logits, a decode step each attention layer's q, k, v and the
    logits); K2 ran on each rank's heads in the stablelm prefills and K3
    on each rank's channels in falcon-mamba's. Returns each run's summary
    and the launches summed over runs and ranks."""
    out, launches = {}, {"flash_attention": 0, "mamba_scan": 0}
    kernel_errs = _kernels_at_serve_shapes(runs, dev, card)
    for run, per in zip(runs, per_run):
        cfg = run.config()
        r0 = per[0]
        if any((r["tokens"] != r0["tokens"]).any() for r in per):
            raise SystemExit(f"[serve_tp] {run.name}: the ranks' tokens "
                             f"differ {[r['tokens'] for r in per]}")
        same = bool((r0["single_tokens"] == r0["tokens"]).all())
        fp32 = cfg.compute_dtype == "float32"
        if fp32 and (not same or r0["logits_max_abs"] > LOGIT_TOL):
            raise SystemExit(f"[serve_tp] {run.name}: tokens "
                             f"{r0['tokens'].tolist()} against one "
                             f"device's {r0['single_tokens'].tolist()}, "
                             f"logits {r0['logits_max_abs']} apart")
        plain_same = bool((r0["plain_tokens"] == r0["tokens"]).all())
        plain_logits = max(r0["plain_logits_max_abs"])
        plain_rel = r0["plain_logits_max_abs"][0] / r0["plain_logits_std"][0]
        if fp32 and (not plain_same or plain_logits > LOGIT_TOL
                     or r0["plain_cache_rel"] > STATE_TOL):
            raise SystemExit(f"[serve_tp] {run.name}: against the plain "
                             f"path tokens {r0['plain_tokens'].tolist()}, "
                             f"logits {r0['plain_logits_max_abs']} apart, "
                             f"cache {r0['plain_cache_rel']} of max(1, "
                             "|plain|)")
        if not fp32 and plain_rel > STEP_REL_TOL[cfg.compute_dtype]:
            raise SystemExit(f"[serve_tp] {run.name}: prefill logits "
                             f"{plain_rel} of the plain ones' spread")
        if not cfg.attention_free:
            L, KV = cfg.num_layers, cfg.num_kv_heads
            want = (L, run.batch, KV, run.max_len // 2, cfg.hd)
            if any(r["kv_shape"] != want
                   or 2 * r["kv_bytes"] != r0["single_kv_bytes"]
                   for r in per):
                raise SystemExit(f"[serve_tp] {run.name}: K/V "
                                 f"{[r['kv_shape'] for r in per]} "
                                 f"{[r['kv_bytes'] for r in per]} B, one "
                                 f"device {r0['single_kv_bytes']} B")
        n_attn = 0 if cfg.attention_free else cfg.num_layers
        for r in per:
            k2 = r["launches"].get("flash_attention", 0)
            k3 = r["launches"].get("mamba_scan", 0)
            if (k2, k3) != (n_attn, cfg.num_layers if cfg.ssm else 0):
                raise SystemExit(f"[serve_tp] {run.name} rank {r['rank']} "
                                 f"launched {r['launches']}")
            launches["flash_attention"] += k2
            launches["mamba_scan"] += k3
            if run.mesh == (1, 2):
                pre = r["prefill_counters"]["calls"].get("all_gather")
                dec = {c["calls"].get("all_gather")
                       for c in r["decode_counters"]}
                if pre != 1 or dec != {1 + n_attn}:
                    raise SystemExit(f"[serve_tp] {run.name}: gathers "
                                     f"{r['prefill_counters']} "
                                     f"{r['decode_counters'][0]}")
        out[run.name] = {
            "arch": run.arch, "mesh": list(run.mesh), "layers":
            cfg.num_layers, "batch": [run.batch, run.prompt, run.max_len],
            "dtype": cfg.compute_dtype, "tokens": r0["tokens"].tolist(),
            "single_tokens_equal": same,
            "logits_max_abs": r0["logits_max_abs"],
            "plain_tokens_equal": plain_same,
            "plain_logits_max_abs": r0["plain_logits_max_abs"],
            "plain_prefill_logits_rel": plain_rel,
            "plain_cache_max_abs": r0["plain_cache_max_abs"],
            "plain_cache_rel": r0["plain_cache_rel"],
            "kv_bytes": [r["kv_bytes"] for r in per],
            "single_kv_bytes": r0["single_kv_bytes"],
            "kv_shape": r0["kv_shape"],
            "prefill_collectives": [r["prefill_counters"] for r in per],
            "decode_collectives": [r["decode_counters"][0] for r in per],
            "launches": [r["launches"].get(k, 0) for r in per
                         for k in ("flash_attention", "mamba_scan")],
            "walls_s": [r["walls"] for r in per],
            "single_walls_s": r0["single_walls"],
            "peak_bytes": [r["peak_bytes"] for r in per],
            "run_s": [r["run_s"] for r in per]}
        log(f"[serve_tp] {run.name} ({run.arch}, {cfg.num_layers} layers, "
            f"{cfg.compute_dtype}, full width, {run.batch} x {run.prompt} "
            f"into {run.max_len}, {run.steps} greedy steps, mesh "
            f"{run.mesh}) on {card}: tokens {r0['tokens'].tolist()}, one "
            f"device's {'equal' if same else 'not equal'}; logits "
            f"{r0['logits_max_abs']:.3e} apart at most; against the plain "
            f"path (no kernel) tokens "
            f"{'equal' if plain_same else 'not equal'}, logits "
            f"{plain_logits:.3e} apart at most (prefill {plain_rel:.3e} of "
            f"their spread), rank 0's cache {r0['plain_cache_max_abs']:.3e}"
            f" apart ({r0['plain_cache_rel']:.3e} of max(1, |plain|)); K/V "
            f"a rank "
            f"{out[run.name]['kv_bytes']} B {r0['kv_shape']} against one "
            f"device's {r0['single_kv_bytes']} B; collectives a rank "
            f"prefill {out[run.name]['prefill_collectives']} decode "
            f"{out[run.name]['decode_collectives']}; launches (K2, K3) "
            f"by rank {out[run.name]['launches']}; walls (prefill, then "
            f"each step) {[[round(w, 4) for w in r['walls']] for r in per]}"
            f" s, one device {[round(w, 4) for w in r0['single_walls']]} s "
            f"(host-staged gloo: not a speed); peak "
            f"{out[run.name]['peak_bytes']} B")
    secs = [round(sum(r["run_s"] for r in per), 1) for per in
            zip(*per_run)]
    log(f"[time] train_mesh: the serve runs {secs} s by rank, set-up and "
        "the single-device runs included")
    return {"runs": out, "launches": launches,
            "kernels_vs_plain": kernel_errs}


def _session(n: int, runs: tuple, dev, what: str) -> list:
    """``runs`` on ``n`` gloo ranks sharing the card; each rank's results."""
    from repro_torch.bench.train_mesh import Runs
    from repro_torch.launch.mesh import MeshSession
    t0 = time.perf_counter()
    with MeshSession(n, "gloo", Runs(runs), dev, timeout=TRAIN_MESH_JOIN_S,
                     op_timeout_s=TRAIN_MESH_OP_S) as s:
        log(f"[train_mesh] {n} gloo ranks on {dev} up in "
            f"{time.perf_counter() - t0:.1f}s; "
            "allow_bf16_reduced_precision_reduction="
            f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
        s.run()
    log(f"[time] train_mesh: {what} {time.perf_counter() - t0:.1f}s")
    return s.results


def phase_train_mesh(dev, card: str) -> dict:
    """Sharded training on TRAIN_MESH_RANKS gloo ranks sharing the card
    (this process and one spawned rank, one ``MeshSession``): the (2, 1)
    runs (every leaf gathered whole) and the (1, 2) runs (the products
    partitioned over the model axis, falcon-mamba's K3 and its backward on
    each rank's dI / 2 channels, qwen2-moe's experts, zamba2's SSD heads);
    then the partitioned serve steps in the same session
    (:func:`_serve_mesh_runs`, ``res["serve_tp"]``); then internvl2-1b on
    TRAIN_MESH_VLM_RANKS ranks (1, 4), attention whole; returns each
    run's summary (``res[name]["launches"]``: the ranks' kernel
    launches)."""
    from repro_torch.bench.train_mesh import compare_states, single_run

    seq = TRAIN_MESH_SEQ
    runs = _train_mesh_runs()
    serve = _serve_mesh_runs()
    fp32 = runs[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = _session(TRAIN_MESH_RANKS, runs + serve, dev, "the session")
    vlm_runs = _train_mesh_vlm_runs()
    vlm_ranks = _session(TRAIN_MESH_VLM_RANKS, vlm_runs, dev,
                         "the internvl2-tp session")
    t1 = time.perf_counter()
    one = single_run(fp32, dev)
    log(f"[time] train_mesh: the single-device fp32 step "
        f"{time.perf_counter() - t1:.1f}s")
    res = {}
    for group_runs, group_ranks in ((runs, ranks), (vlm_runs, vlm_ranks)):
        for i, run in enumerate(group_runs):
            res[run.name] = _train_mesh_summary(
                run, [r[i] for r in group_ranks], card)
    b0, b1 = res["bf16-hoist0"], res["bf16-hoist1"]
    g0 = b0["collective_calls"]["all_gather"]
    g1 = b1["collective_calls"]["all_gather"]
    if g0 != 2 * g1:
        raise SystemExit(f"[train_mesh] all-gathers: {g0} unhoisted (2 "
                         f"microbatches) against {g1} hoisted")
    for name in ("fp32-tp", "falcon-mamba-tp", "moe-tp", "moe-tp-bf16"):
        for rc in res[name]["rank_collectives"]:
            if "all_gather" in rc["calls"]:
                raise SystemExit(f"[train_mesh] {name}: the (1, 2) step "
                                 f"all-gathered a leaf {rc}")
    _check_moe_tp(runs, ranks, res, card)
    _check_zamba2_tp(runs, ranks, res, card)
    _check_vlm_tp(vlm_runs, vlm_ranks, res, card)
    names = [run.name for run in runs]
    for name in ("fp32", "fp32-tp"):
        idx = names.index(name)
        cmp = compare_states(ranks[0][idx]["whole"], one["whole"],
                             ranks[0][idx]["history"], one["history"],
                             fp32.lr)
        res[name]["vs_single"] = cmp
        log(f"[train_mesh] {name} ({TRAIN_MESH_FP32_LAYERS} layers, full "
            f"width, 2 x {seq}, mesh {runs[idx].mesh}): 2 ranks "
            f"{ranks[0][idx]['history']} | one device {one['history']} | "
            f"{cmp} (tolerances {TRAIN_MESH_TOL})")
        if _beyond_tol(cmp):
            raise SystemExit(f"[train_mesh] the 2-rank fp32 step ({name}) "
                             "differs from the single-device step")
    res["fp32"]["single_peak_bytes"] = one["peak_bytes"]
    res["fp32"]["single_history"] = one["history"]
    log(f"[train_mesh] single-device fp32 peak {one['peak_bytes']} B")
    del one
    for name in ("falcon-mamba", "falcon-mamba-tp"):
        for r, counts in enumerate(res[name]["rank_launches"]):
            if not counts["mamba_scan"] or not counts["mamba_scan_bwd"]:
                raise SystemExit(f"[train_mesh] {name} rank {r} launched "
                                 f"{counts}")
        log(f"[train_mesh] falcon-mamba-7b under the group, mesh "
            f"{res[name]['mesh']}: K3 and its backward launched "
            f"{res[name]['rank_launches']} by rank")
    res["k3_at_rank_width"] = _k3_at_widths(dev, card)
    res["serve_tp"] = _check_serve_tp(
        serve, [[r[len(runs) + j] for r in ranks if r[len(runs) + j]]
                for j in range(len(serve))], dev, card)
    print(json.dumps({"train_mesh": res}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _train_mesh_summary(run, per: list, card: str) -> dict:
    """One train_mesh run's summary from its ranks' results, after the
    checks every run holds: each rank's state bytes are its specs'
    blocks, the metrics finite, a run of several steps moving its loss."""
    for r in per:
        want = _sharded_leaf_bytes(r["leaf_shapes_specs"], run.mesh)
        if not (r["param_bytes"] == r["spec_bytes"] == want
                and r["moment_bytes"] == 2 * want):
            raise SystemExit(f"[train_mesh] {run.name} rank {r['rank']}: "
                             f"params {r['param_bytes']} B, moments "
                             f"{r['moment_bytes']} B, specs "
                             f"{r['spec_bytes']} B, want {want} B")
    hist = per[0]["history"]
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite([h["loss"] for h in hist]
                           + [h["grad_norm"] for h in hist])):
        raise SystemExit(f"[train_mesh] {run.name}: not finite {hist}")
    if run.steps > 1 and len(set(losses)) < 2:
        raise SystemExit(f"[train_mesh] {run.name}: losses do not move "
                         f"{losses}")
    c = per[0]["counters"]
    kinds = ("mamba_scan", "mamba_scan_bwd", "flash_attention",
             "paged_attention")
    out = {
        "arch": run.arch, "mesh": list(run.mesh),
        "layers": run.config().num_layers, "batch": [run.batch, run.seq],
        "steps": run.steps, "loss": losses,
        "grad_norm": [h["grad_norm"] for h in hist],
        "param_bytes": [r["param_bytes"] for r in per],
        "moment_bytes": [r["moment_bytes"] for r in per],
        "full_param_bytes": per[0]["full_bytes"],
        "peak_bytes": [r["peak_bytes"] for r in per],
        "walls_s": [r["walls"] for r in per],
        "run_s": [r["run_s"] for r in per],
        "collective_calls": c["calls"], "collective_max_bytes":
            c["max_bytes"],
        "rank_collectives": [r["counters"] for r in per],
        "rank_launches": [{k: r["launches"].get(k, 0) for k in kinds}
                          for r in per],
        "launches": {k: sum(r["launches"].get(k, 0) for r in per)
                     for k in kinds}}
    log(f"[train_mesh] {run.name} ({run.arch}, {out['layers']} "
        f"layers, full width, batch {run.batch} x {run.seq}, "
        f"{run.steps} step(s), mesh {run.mesh}) on {card}: losses "
        f"{losses}; per rank params {out['param_bytes']} B and "
        f"moments {out['moment_bytes']} B of "
        f"{per[0]['full_bytes']} B whole (each leaf over the ranks its "
        f"spec shards it across); peak device memory "
        f"{[r['peak_bytes'] for r in per]} B; collectives by rank "
        f"{[r['counters'] for r in per]} (calls, largest bytes); step "
        f"walls {[[round(w, 3) for w in r['walls']] for r in per]} s "
        f"(host-staged gloo, {len(per)} ranks on one card: not a speed); "
        f"the run {[round(r['run_s'], 1) for r in per]} s with its set-up;"
        f" launches by rank {out['rank_launches']}")
    return out


def _beyond_tol(c: dict) -> bool:
    """True when a compare_states result is beyond TRAIN_MESH_TOL."""
    return c["metric_rel"] > TRAIN_MESH_TOL["metric"] \
        or max(c["m_rel"], c["v_rel"]) > TRAIN_MESH_TOL["moment"] \
        or c["param_lr"] > TRAIN_MESH_TOL["param_lr"] \
        or c["ill_param_lr"] > TRAIN_MESH_TOL["ill_param_lr"]


def _vs_single(name: str, per: list, res: dict, what: str,
               card: str) -> None:
    """A ``vs_single`` run's ranks, each holding its blocks against the
    same blocks of the single-device step on the card: logged, and within
    TRAIN_MESH_TOL on every rank."""
    cmps = [r["vs_single"] for r in per]
    res[name]["vs_single"] = cmps
    shown = [{k: v for k, v in c.items() if k != "single_history"}
             for c in cmps]
    log(f"[train_mesh] {name} ({what}) on {card}: each rank's blocks "
        f"against one device's {shown}; the ranks "
        f"{[r['history'] for r in per]} | one device "
        f"{cmps[0]['single_history']} (tolerances {TRAIN_MESH_TOL})")
    if any(_beyond_tol(c) for c in cmps):
        raise SystemExit(f"[train_mesh] {name} differs from the "
                         "single-device step")


def _check_moe_tp(runs, ranks, res, card: str) -> None:
    """qwen2-moe's (1, 2) runs: each rank's expert leaves hold half the
    experts a layer (30 of 60 at full width), and each rank's fp32 blocks
    agree with the same blocks of the single-device step within
    TRAIN_MESH_TOL."""
    names = [run.name for run in runs]
    for name in ("moe-tp", "moe-tp-bf16"):
        per = [r[names.index(name)] for r in ranks]
        E = runs[names.index(name)].config().num_experts
        experts = [[b[1] for (full, _), b in zip(r["leaf_shapes_specs"],
                                                 r["block_shapes"])
                    if len(full) == 4 and full[1] == E] for r in per]
        res[name]["experts_a_rank"] = experts
        if any(e != [E // 2] * 3 for e in experts):
            raise SystemExit(f"[train_mesh] {name}: expert leaves hold "
                             f"{experts} experts a rank, not {E // 2} of "
                             f"{E}")
    _vs_single("moe-tp", [r[names.index("moe-tp")] for r in ranks], res,
               f"qwen2-moe-a2.7b, {TRAIN_MESH_MOE_LAYERS} layers, full "
               f"width, 2 x {TRAIN_MESH_SEQ}, mesh (1, 2); expert leaves "
               f"{res['moe-tp']['experts_a_rank']} experts a rank", card)
    walls = [round(r[names.index(n)]["run_s"], 1)
             for n in ("moe-tp", "moe-tp-bf16") for r in ranks]
    log(f"[time] train_mesh: the moe-tp runs {walls} s by run and rank, "
        "set-up and the single-device turns included")


def _check_zamba2_tp(runs, ranks, res, card: str) -> None:
    """zamba2's (1, 2) run: each rank all-gathers only the shared block's
    ``fused_proj`` output (its forward and remat's recompute, a
    2 x 2,048 x 2,048 fp32 activation), no leaf; its fp32 blocks agree
    with the single-device step's within TRAIN_MESH_TOL."""
    i = [run.name for run in runs].index("zamba2-tp")
    cfg = runs[i].config()
    G = cfg.num_layers // cfg.hybrid_attn_every
    act = runs[i].batch * runs[i].seq * cfg.d_model * 4
    for rc in res["zamba2-tp"]["rank_collectives"]:
        if rc["calls"].get("all_gather") != 2 * G \
                or rc["max_bytes"].get("all_gather") != act:
            raise SystemExit(f"[train_mesh] zamba2-tp gathered more than "
                             f"{2 * G} activations of {act} B: {rc}")
    per = [r[i] for r in ranks]
    single = [r["vs_single"]["single_peak_bytes"] for r in per]
    _vs_single("zamba2-tp", per, res,
               f"zamba2-1.2b, {cfg.num_layers} Mamba2 layers and the "
               f"shared block, full width, 2 x {TRAIN_MESH_SEQ}, mesh "
               f"(1, 2); peak a rank {res['zamba2-tp']['peak_bytes']} B, "
               f"one device's {single} B in each rank's turn", card)
    log(f"[time] train_mesh: the zamba2-tp run "
        f"{[round(r['run_s'], 1) for r in per]} s by rank, set-up and "
        "the single-device turns included")


def _check_vlm_tp(runs, ranks, res, card: str) -> None:
    """internvl2's (1, 4) run: each rank holds a quarter of each MLP and
    embedding (and head) leaf; it gathers its attention leaves whole (14
    query heads: attention whole on every rank); its fp32 blocks agree
    with the single-device step's within TRAIN_MESH_TOL."""
    (run,) = runs
    cfg, n = run.config(), run.mesh[1]
    per = [r[0] for r in ranks]
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    # the embedding (tied: the head too), wi and wg, wd
    want = {(cfg.padded_vocab, D): (cfg.padded_vocab // n, D),
            (L, D, F): (L, D, F // n), (L, F, D): (L, F // n, D)}
    for r in per:
        shapes = [(tuple(full), tuple(b)) for (full, _), b in
                  zip(r["leaf_shapes_specs"], r["block_shapes"])]
        if sum(full in want for full, _ in shapes) != 4 or any(
                b != want[full] for full, b in shapes if full in want):
            raise SystemExit(f"[train_mesh] internvl2-tp rank {r['rank']}:"
                             f" blocks {shapes}, want {want}")
        if r["counters"]["calls"].get("all_gather") != 7:
            raise SystemExit(f"[train_mesh] internvl2-tp rank {r['rank']}:"
                             f" gathers {r['counters']}, want the 7 "
                             "attention leaves")
    _vs_single("internvl2-tp", per, res,
               f"internvl2-1b, {cfg.num_layers} layers, full width, 2 x "
               f"({cfg.frontend_tokens} frames + {run.seq} tokens), mesh "
               f"{run.mesh}, attention whole; peak a rank "
               f"{res['internvl2-tp']['peak_bytes']} B, one device's "
               f"{[r['vs_single']['single_peak_bytes'] for r in per]} B in "
               "each rank's turn", card)
    log(f"[time] train_mesh: the internvl2-tp run "
        f"{[round(r['run_s'], 1) for r in per]} s by rank, set-up and "
        "the single-device turns included")


def _k3_at_widths(dev, card: str) -> dict:
    """K3's training entry (the states kept) and its backward at a (1, 2)
    rank's falcon-mamba-7b shape, dI = 4096, beside one device's, dI =
    8192: B=1, S=TRAIN_MESH_SEQ, N=16, bf16 x/B/C, timed with CUDA events
    on the free card."""
    from repro_torch.kernels import mamba_scan as scan_mod
    from repro_torch.kernels import mamba_scan_bwd as bwd_mod
    g = torch.Generator(dev).manual_seed(9)
    out = {}
    for dI in (4096, 8192):
        B, S, N = 1, TRAIN_MESH_SEQ, 16

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        dt = F.softplus(randn(B, S, dI)) * 0.1
        x, Bc, Cc = (randn(B, S, dI).to(BF16), randn(B, S, N).to(BF16),
                     randn(B, S, N).to(BF16))
        A = -torch.exp(randn(dI, N) * 0.5)
        dy = randn(B, S, dI)
        _, _, hs = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A,
                                            save_states=True)
        fwd = time_ms(lambda: scan_mod.mamba_scan_cuda(
            dt, x, Bc, Cc, A, save_states=True), iters=20)
        bwd = time_ms(lambda: bwd_mod.mamba_scan_bwd_cuda(
            dt, x, Bc, Cc, A, hs, dy), iters=20)
        out[dI] = {"fwd_ms": fwd, "bwd_ms": bwd}
        del dt, x, Bc, Cc, A, dy, hs
    log(f"[train_mesh] K3 (training entry, states kept) and its backward "
        f"at B=1 S={TRAIN_MESH_SEQ} N=16 bf16 on {card}: dI=4096 (a (1, 2) "
        f"rank's) fwd {out[4096]['fwd_ms']:.4f} ms, bwd "
        f"{out[4096]['bwd_ms']:.4f} ms; dI=8192 (one device's) fwd "
        f"{out[8192]['fwd_ms']:.4f} ms, bwd {out[8192]['bwd_ms']:.4f} ms")
    return out


# --------------------------------------------------------------- phase 11f
#: the mesh_durable phase: stablelm-1.6b at full width in fp32 at
#: MESH_FP32_LAYERS layers (TF32 off), the parity prompts (lengths 23 to
#: 41, two sharing prompt 0's first 16 and 12 tokens), new tokens a request
MESH_DURABLE_DIR = Path("build") / "mesh_durable"
MESH_DURABLE_NEW = 12
MESH_DURABLE_FAULT = "chunk_sync_exc:at=2"
#: the 2-rank snapshot against the plain single-device engine's: the
#: trie, queue and metadata equal, the KV pages within this share of their
#: largest magnitude. The ranks' K and V projections are column slices of
#: the single GEMM, for which cuBLAS picks other fp32 kernels on the card
#: (PR 27 call 1: 7.4e-6 of a 4.7 page maximum, 1.6e-6). Byte for byte,
#: the snapshot equals the single-device engine that computes those
#: slices (``column_slice_params``), as on the CPU it equals the plain one.
MESH_SNAPSHOT_REL = 1e-5
#: how long a follower may outlive its crashed rank 0
MESH_FOLLOWER_GONE_S = 60.0


def _pid_gone(pid: int) -> bool:
    """The process has exited (or is a zombie nobody reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def phase_mesh_durable(dev, card: str) -> dict:
    """Durable serving, failure isolation and the per-call baseline under
    a tensor-parallel group on the card: stablelm-1.6b at full width in
    fp32 at MESH_FP32_LAYERS layers, 2 gloo ranks sharing the card (this
    process and one spawned follower) against the single-device engine
    on the same weights. The 2-rank engine's tokens (journal on, prefix
    cache on, the prompts in two waves) and journal records must equal the
    single engine's, its snapshot bytes the single-device engine's that
    computes the ranks' column slices (``column_slice_params``), and its
    snapshot the plain single engine's but for its KV pages, which stay
    within MESH_SNAPSHOT_REL; a fresh 2-rank engine restored
    from that snapshot serves prompt 4 warm with the same tokens;
    ``chunk_sync_exc:at=2`` fails the same two requests ``RowFailed`` as
    on one device and the later tokens are equal; the per-call baseline's
    tokens are equal; a 2-rank incarnation (``repro_torch.launch.
    incarnation --mesh-model 2``) killed by ``crash_at:at=3`` takes its
    follower down within MESH_FOLLOWER_GONE_S and a fresh 2-rank
    incarnation recovers an uncrashed engine's tokens. Returns both
    ranks' K1 and K2 launches over the 2-rank engines."""
    import shutil

    from repro_torch.bench.serve_mesh import (PARITY_KW, column_slice_params,
                                              compare_snapshots, durable_case,
                                              isolation_case,
                                              journal_records,
                                              parity_prompts, restore_case)
    from repro_torch.kernels import ops
    from repro_torch.launch import incarnation
    from repro_torch.launch.mesh import ModelSpec, TPSession
    from repro_torch.serve.engine import ServeEngine

    spec = ModelSpec("stablelm-1.6b", MESH_PRESET, 0, (
        ("compute_dtype", "float32"), ("num_layers", MESH_FP32_LAYERS)))
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(MESH_DURABLE_DIR, ignore_errors=True)
    cfg, params = spec(dev)
    prompts = parity_prompts(cfg.vocab_size)
    n, fault = MESH_DURABLE_NEW, MESH_DURABLE_FAULT
    t0 = time.perf_counter()
    single = durable_case(cfg, params, dev, MESH_DURABLE_DIR / "single",
                          prompts, n)
    sliced = durable_case(cfg, column_slice_params(cfg, params, MESH_RANKS),
                          dev, MESH_DURABLE_DIR / "sliced", prompts, n)
    s_iso = isolation_case(lambda: ServeEngine(
        cfg, params, device=dev, fault_inject=fault, **PARITY_KW), prompts, n)
    with ServeEngine(cfg, params, device=dev, **PARITY_KW) as eng:
        s_pc = eng._generate_grouped(prompts, n)
    t_single = time.perf_counter() - t0
    before = ops.launch_counts()
    t1 = time.perf_counter()
    with TPSession(MESH_RANKS, "gloo", spec, dev, timeout=600.0) as s:
        t_up = time.perf_counter() - t1
        mesh = durable_case(cfg, params, dev, MESH_DURABLE_DIR / "mesh",
                            prompts, n, tp=s.tp)
        warm = restore_case(cfg, params, dev, mesh["snapshot"], prompts[4],
                            n, tp=s.tp)
        m_iso = isolation_case(lambda: ServeEngine(
            cfg, params, device=dev, tp=s.tp, fault_inject=fault,
            **PARITY_KW), prompts, n)
        with ServeEngine(cfg, params, device=dev, tp=s.tp,
                         **PARITY_KW) as eng:
            m_pc = eng._generate_grouped(prompts, n)
        counters = s.tp.counters()
    t_mesh = time.perf_counter() - t1
    after = ops.launch_counts()
    counts = {k: after[k] - before[k]
              for k in ("paged_attention", "flash_attention")}
    fcounts = {k: sum(e["launches"].get(k, 0)
                      for e in s.followers[0]["result"]) for k in counts}
    if min(fcounts.values()) <= 0 or min(counts.values()) <= 0:
        raise SystemExit(f"[mesh_durable] launches: rank 0 {counts}, "
                         f"follower {fcounts}")

    def same(a, b):
        return len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))

    vs_sliced = compare_snapshots(sliced["snapshot"], mesh["snapshot"])
    vs_single = compare_snapshots(single["snapshot"], mesh["snapshot"])
    checks = {
        "tokens": same(single["outs"], mesh["outs"])
        and same(sliced["outs"], mesh["outs"]),
        "journal_records": journal_records(single["journal"])
        == journal_records(mesh["journal"]),
        "snapshot_bytes_vs_column_slices": vs_sliced["bytes_equal"],
        "snapshot_vs_single": vs_single["rest_equal"]
        and vs_single["pages_max_abs"]
        <= MESH_SNAPSHOT_REL * vs_single["pages_max"],
        "restored_warm": warm["warm_hits"] > 0
        and np.array_equal(warm["out"], single["outs"][4]),
        "isolation_failed_ids": s_iso[0] == m_iso[0] == [0, 1],
        "isolation_later_tokens": same(s_iso[1], m_iso[1]),
        "per_call_tokens": same(s_pc, m_pc),
    }
    res = {"layers": cfg.num_layers, "checks": checks,
           "snapshot_vs_single": vs_single,
           "snapshot_bytes": mesh["snapshot_bytes"],
           "snapshot_s": {"single": single["snapshot_s"],
                          "mesh": mesh["snapshot_s"]},
           "restore_s": warm["restore_s"],
           "warm_started": warm["warm_started"],
           "warm_hits": warm["warm_hits"],
           "collectives": counters, "launches": counts,
           "follower_launches": fcounts,
           "seconds": {"single": t_single, "group_up": t_up,
                       "group": t_mesh}}
    log(f"[mesh_durable] stablelm-1.6b full width, {cfg.num_layers} layers, "
        f"fp32, {MESH_RANKS} gloo ranks on {card}: single-device side "
        f"{t_single:.1f}s, group up in {t_up:.1f}s, group side "
        f"{t_mesh:.1f}s; snapshot {mesh['snapshot_bytes']} B written in "
        f"{mesh['snapshot_s']:.3f}s under the group ({single['snapshot_s']:.3f}"
        f"s on one device), restored in {warm['restore_s']:.3f}s "
        f"({warm['warm_started']} nodes, {warm['warm_hits']} warm hits); "
        f"checks {checks}; against the plain single engine's snapshot "
        f"{vs_single} (its bytes equal: {vs_single['bytes_equal']}); "
        f"collectives {counters['calls']}; launches rank 0 {counts}, "
        f"follower {fcounts}")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"[mesh_durable] failed: {bad}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # crash_at under the group, then recover in a fresh group
    t2 = time.perf_counter()
    c32, p32 = incarnation.model(MESH_FP32_LAYERS, dev)
    with incarnation.engine(c32, p32, dev) as eng:
        oracle = [np.asarray(o).tolist() for o in eng.generate(
            incarnation.prompts(c32.vocab_size), incarnation.MAX_NEW)]
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    state = str(MESH_DURABLE_DIR / "crash")
    base = ["--state-dir", state, "--layers", str(MESH_FP32_LAYERS),
            "--mesh-model", str(MESH_RANKS)]
    ((rc, out, err),) = _durable_procs([base + ["--fault-inject",
                                                "crash_at:at=3"]])
    if rc != 137:
        raise SystemExit(f"[mesh_durable] crash_at: rc {rc}\n{err[-3000:]}")
    pids = [int(p) for line in out.splitlines()
            if line.startswith("FOLLOWERS") for p in line.split()[1]
            .split(",")]
    t_dead = time.perf_counter()
    while not all(_pid_gone(p) for p in pids) and \
            time.perf_counter() - t_dead < MESH_FOLLOWER_GONE_S:
        time.sleep(0.1)
    gone_s = time.perf_counter() - t_dead
    if not pids or not all(_pid_gone(p) for p in pids):
        raise SystemExit(f"[mesh_durable] followers {pids} outlived rank 0 "
                         f"by {MESH_FOLLOWER_GONE_S} s")
    ((rc2, out2, err2),) = _durable_procs([base + ["--no-submit"]])
    done, _ = _parse_durable(out)
    _, replayed = _parse_durable(out2)
    lost = [i for i in range(len(oracle))
            if (done.get(i) or replayed.get(i)) != oracle[i]]
    if rc2 != 0 or not replayed or lost:
        raise SystemExit(f"[mesh_durable] recover: rc {rc2}, replayed "
                         f"{sorted(replayed)}, wrong or lost {lost}\n"
                         f"{err2[-3000:]}")
    res["crash"] = {"followers": pids, "followers_gone_s": gone_s,
                    "replayed": sorted(replayed), "done": sorted(done),
                    "seconds": time.perf_counter() - t2}
    log(f"[mesh_durable] crash_at:at=3 in a {MESH_RANKS}-rank incarnation: "
        f"rc 137, follower(s) {pids} gone {gone_s:.2f}s after rank 0; a "
        f"fresh {MESH_RANKS}-rank incarnation replayed {sorted(replayed)} "
        f"with an uncrashed engine's tokens ({len(done)} done before the "
        f"crash) in {res['crash']['seconds']:.1f}s")
    print(json.dumps({"mesh_durable": res}), flush=True)
    return {k: counts[k] + fcounts[k] for k in counts}


# --------------------------------------------------------------- phase 11g
class _MetaScanFn(torch.autograd.Function):
    """K3 and its backward as the meta device sees them: outputs and
    gradients of their shapes, no arithmetic."""

    @staticmethod
    def forward(ctx, dt, x, Bc, Cc, A):
        ctx.shapes = [(t.shape, t.dtype) for t in (dt, x, Bc, Cc, A)]
        return dt.new_empty(dt.shape), dt.new_empty(
            (dt.shape[0],) + tuple(A.shape))

    @staticmethod
    def backward(ctx, dy, dhT):
        return tuple(dy.new_empty(sh, dtype=dt) for sh, dt in ctx.shapes)


def _meta_scan():
    """Within it, the dry run takes K3 (forward and backward) as one op
    each, as the card runs them, where the meta device would step the
    plain scan's 2,048 steps one by one (~100 s a falcon-mamba-7b step at
    4 layers on the host): the collectives and the products' FLOPs are the
    same, the plain scan's own per-step products are not counted."""
    from unittest import mock

    from repro_torch.kernels import ops
    return mock.patch.object(
        ops, "mamba_scan",
        lambda dt, x, Bc, Cc, A, h0=None: _MetaScanFn.apply(dt, x, Bc, Cc,
                                                            A))


def _dryrun_mesh_runs(train_mesh: dict) -> dict:
    """The train_mesh runs on the meta device against their live
    counters (see :func:`phase_dryrun`)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.op_analysis import (DryMeshGroup,
                                                     StepCost, analyze_step,
                                                     replicated_flops)
    from repro_torch.launch.mesh import make_ctx, small_mesh
    from repro_torch.train.train_step import train_input_specs

    out = {}
    runs = _train_mesh_runs()
    for run in runs[:3] + runs[4:] + _train_mesh_vlm_runs():
        t1 = time.perf_counter()
        mesh = small_mesh(*run.mesh)
        # rank 0 of the (2, 1) runs; every rank of the partitioned (1, 2)
        # and (1, 4) runs, and beside them the same rows on one device (a
        # (1, 1) mesh): a rank's FLOPs are 1/tp of its, but for what every
        # rank forms whole (replicated_flops)
        ranks = range(mesh.size) if run.mesh[1] > 1 else (0,)
        pred, flops, rest = [], [], []
        scan = _meta_scan() if run.arch == "falcon-mamba-7b" \
            else contextlib.nullcontext()
        for rank in list(ranks) + ([None] if run.mesh[1] > 1 else []):
            m = mesh if rank is not None else small_mesh(1, 1)
            ctx = make_ctx(m, DryMeshGroup(m, rank or 0, StepCost()))
            step, args, _ = train_input_specs(
                run.config(), ctx, ShapeSpec("t", run.seq, run.batch,
                                             "train"),
                opt=run.opt(), microbatches=run.microbatches)
            with scan:
                analyze_step(step, *args, cost=ctx.group.cost)
            del args
            flops.append(ctx.group.cost.flops)
            rest.append((ctx.group.cost.transcendentals,
                         ctx.group.cost.bytes_accessed,
                         ctx.group.cost.peak_bytes))
            if rank is None:
                continue
            one = ctx.group.counters()
            pred.append({"calls": {k: v * run.steps
                                   for k, v in one["calls"].items()},
                         "max_bytes": one["max_bytes"]})
        live = train_mesh[run.name]["rank_collectives"][:len(pred)]
        out[run.name] = {"predicted": pred, "live": live,
                         "flops": flops, "rest": rest,
                         "live_peak_bytes":
                             train_mesh[run.name]["peak_bytes"],
                         "seconds": time.perf_counter() - t1}
        log(f"[dryrun] train_mesh {run.name} ({run.config().num_layers} "
            f"layers, {run.batch} x {run.seq}, {run.steps} step(s), mesh "
            f"{run.mesh}): predicted by rank {pred}, live {live}; FLOPs a "
            f"step by rank {flops[:len(pred)]}"
            + (f", one device {flops[-1]:.6e} ({flops[0] / flops[-1]:.6f}x)"
               if run.mesh[1] > 1 else "")
            + "; transcendentals, bytes accessed and peak bytes by rank "
            f"(the last one device's where there is one) {rest}; live "
            f"peak by rank {train_mesh[run.name]['peak_bytes']}"
            + f" ({time.perf_counter() - t1:.1f}s)")
        if pred != live:
            raise SystemExit(f"[dryrun] {run.name}: predicted collectives "
                             "differ from the live counters")
        if run.mesh[1] == 1:
            continue
        R = replicated_flops(run.config(), run.batch // run.mesh[0],
                             run.seq, run.mesh[1])
        out[run.name]["replicated_flops"] = R
        if any(f != (flops[-1] - R) / run.mesh[1] + R for f in flops[:-1]):
            raise SystemExit(f"[dryrun] {run.name}: a rank's FLOPs are not "
                             f"1/{run.mesh[1]} of one device's but for the "
                             f"{R:.6e} every rank forms whole")
    return out


def _dryrun_serve_runs(live: dict) -> dict:
    """The serve runs' prefill and decode steps on the meta device, each
    rank's, against the collectives the ranks counted live (every decode
    step's the same)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.op_analysis import (DryMeshGroup,
                                                     StepCost, analyze_step)
    from repro_torch.launch.mesh import make_ctx, small_mesh
    from repro_torch.train.train_step import (make_decode_step,
                                              make_prefill_step)
    out = {}
    for run in _serve_mesh_runs():
        t1 = time.perf_counter()
        mesh, cfg = small_mesh(*run.mesh), run.config()
        scan = _meta_scan() if cfg.ssm else contextlib.nullcontext()
        pred = []
        for rank in range(mesh.size):
            got = []
            for kind in ("prefill", "decode"):
                ctx = make_ctx(mesh, DryMeshGroup(mesh, rank, StepCost()))
                if kind == "prefill":
                    step, args, _ = make_prefill_step(
                        cfg, ctx, ShapeSpec("p", run.prompt, run.batch,
                                            "prefill"),
                        max_len=run.max_len)
                else:
                    step, args, _ = make_decode_step(
                        cfg, ctx, ShapeSpec("d", run.max_len, run.batch,
                                            "decode"),
                        serve_tp_only=run.serve_tp_only)
                with scan:
                    analyze_step(step, *args, cost=ctx.group.cost)
                del args
                got.append(ctx.group.counters())
            pred.append(got)
        have = [[p, d] for p, d in zip(live[run.name]["prefill_collectives"],
                                       live[run.name]["decode_collectives"])]
        out[run.name] = {"predicted": pred, "live": have,
                         "seconds": time.perf_counter() - t1}
        log(f"[dryrun] serve_tp {run.name} (prefill, decode) predicted by "
            f"rank {pred}, live {have} ({out[run.name]['seconds']:.1f}s)")
        if pred != have:
            raise SystemExit(f"[dryrun] {run.name}: predicted collectives "
                             "differ from the live counters")
    return out


def phase_dryrun(train: dict, train_mesh: dict, card: str) -> dict:
    """The dry run (``repro_torch.distributed.op_analysis`` on the meta
    device, nothing launched) beside what the train and train_mesh phases
    measured: stablelm-1.6b's single-device step at TRAIN_BATCH x
    TRAIN_SEQ (TRAIN_MB microbatches, remat as the trainer runs it) must
    predict the trainer's state bytes plus the batch as its argument
    bytes exactly, and its predicted peak is printed beside the trainer's
    ``max_memory_allocated``; for train_mesh's runs, one step's predicted
    collectives (calls times the run's steps, and the largest bytes, by
    kind) must equal the live ``MeshGroup`` counters, rank 0's on the
    (2, 1) mesh and every rank's on the (1, 2) and (1, 4) meshes, whose
    FLOPs a rank must be exactly 1/tp of the same rows' on one device, but
    for what every rank forms whole (a MoE layer's router and shared gate,
    Mamba2's B and C, attention kept whole: ``op_analysis.
    replicated_flops``); and each rank's predicted prefill and decode
    collectives of the serve runs must equal its live counters."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.op_analysis import analyze_step
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.launch.train import build_cfg
    from repro_torch.optim import OptConfig
    from repro_torch.train.train_step import train_input_specs

    t0 = time.perf_counter()
    cfg, _, _ = build_cfg("stablelm-1.6b", "full")
    opt = OptConfig(lr=3e-4, warmup_steps=max(10, TRAIN_STEPS // 20),
                    total_steps=TRAIN_STEPS)
    step, args, _ = train_input_specs(
        cfg, ShardCtx(mesh=None), ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                            "train"),
        opt=opt, microbatches=TRAIN_MB)
    cost = analyze_step(step, *args)
    del args
    live_args = train["snapshot_bytes"] + TRAIN_BATCH * TRAIN_SEQ * 4
    res = {"train": {"argument_bytes": cost.argument_bytes,
                     "live_argument_bytes": live_args,
                     "predicted_peak_bytes": cost.peak_bytes,
                     "measured_peak_bytes": train["peak_bytes"],
                     "predicted_flops": cost.flops,
                     "predicted_bytes_accessed": cost.bytes_accessed,
                     "seconds": time.perf_counter() - t0}}
    log(f"[dryrun] {cfg.name} single-device step, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, {TRAIN_MB} microbatches, on the meta device in "
        f"{res['train']['seconds']:.1f}s: argument bytes {cost.argument_bytes}"
        f" predicted, {live_args} live (the trainer's params and AdamW "
        f"state, {train['snapshot_bytes']} B, and the batch); peak "
        f"{cost.peak_bytes / 1e9:.3f} GB predicted against "
        f"{train['peak_bytes'] / 1e9:.3f} GB max_memory_allocated on {card} "
        f"({cost.peak_bytes / train['peak_bytes']:.3f}x); {cost.flops:.4e} "
        f"FLOPs, {cost.bytes_accessed:.4e} bytes accessed a step")
    if cost.argument_bytes != live_args:
        raise SystemExit("[dryrun] the predicted argument bytes are not the "
                         "trainer's state and batch")
    res["train_mesh"] = _dryrun_mesh_runs(train_mesh)
    res["serve_tp"] = _dryrun_serve_runs(train_mesh["serve_tp"]["runs"])
    print(json.dumps({"dryrun": res}), flush=True)
    return res


# ------------------------------------------------------------------ main
def _check_serve_run(run, tag: str, n_req: int, vocab: int) -> dict:
    """The gates every serve-suite run holds: in-vocab tokens for every
    request, TTFT counted once per request, spans on the engine, slot and
    line tracks, every slot free, and every block free with refcount 0
    once the prefix trie (if any) is evicted. Returns the run's metric
    snapshot."""
    eng, obs = run["eng"], run["obs"]
    for o in run["outs"]:
        if o.ndim != 1 or len(o) == 0 \
                or not ((o >= 0) & (o < vocab)).all():
            raise SystemExit(f"[{tag}] bad output {o}")
    if len(run["outs"]) != n_req:
        raise SystemExit(f"[{tag}] {len(run['outs'])} of {n_req} results")
    snap = obs.metrics.snapshot()
    if snap["serve.ttft_s"]["count"] != n_req:
        raise SystemExit(f"[{tag}] serve.ttft_s.count "
                         f"{snap['serve.ttft_s']['count']} != {n_req}")
    tracks = {s[1] for s in obs.tracer.spans()}
    for kind in ("engine", "slot", "line"):
        if not any(t.startswith(kind) for t in tracks):
            raise SystemExit(f"[{tag}] no span on a {kind} track: {tracks}")
    if len(eng._free_slots) != len(eng._slot_req) \
            or any(r is not None for r in eng._slot_req):
        raise SystemExit(f"[{tag}] slots still held at the end")
    pool, px = eng._pool, eng._prefix
    parked = px.num_parked if px is not None else 0
    if px is not None:
        px.evict(px.num_nodes)
    refs = [pool.refcount(b) for b in range(1, pool.num_blocks)]
    if pool.num_free != pool.num_blocks - 1 or any(refs) \
            or (px is not None and px.num_nodes):
        raise SystemExit(f"[{tag}] blocks leaked: {pool.num_free} free of "
                         f"{pool.num_blocks - 1}, refcounts {sum(refs)}")
    log(f"[{tag}] {n_req} requests in {run['dt']:.3f}s, "
        f"{len(obs.tracer)} spans ({obs.tracer.dropped} dropped), every "
        f"slot free, {parked} parked blocks evicted, all "
        f"{pool.num_blocks - 1} blocks free at refcount 0; stats "
        f"{run['stats']}")
    return snap


def _first_flip_margin(cfg, params, prompt, a, b, dev) -> str:
    """Where two token streams of one prompt first differ: the position
    and the top-2 logit margin of a contiguous prefill of the prompt and
    the shared tokens before it."""
    from repro_torch.models import lm
    j = int(np.nonzero(np.asarray(a) != np.asarray(b))[0][0])
    seq = np.concatenate([prompt, np.asarray(a[:j], np.int32)])
    with torch.inference_mode():
        logits, _ = lm.prefill(cfg, params,
                               torch.from_numpy(seq[None]).to(dev))
    top2 = logits[0].float().topk(2).values
    return f"token {j}, top-2 margin {(top2[0] - top2[1]).item():.4e}"


def phase_prefix(dev, cfg, params, card: str) -> dict:
    """The port's prefix-share workload at stablelm-1.6b's full width and
    depth (``params``: the serve phase's seeded bf16 weights), cold and
    warm, each with an ``Observability`` attached and its trace exported;
    every run's gates (``_check_serve_run``); the warm run's hits, saved
    tokens and forks; K1 in both runs; warm against cold tokens, equal in
    fp32 compute at full width and PREFIX_FP32_LAYERS layers (and the cold
    pass on the eager chunk equal to the captured chunk's), and their match
    share and first flip's margin in bf16; then the obs gate's measurement
    (printed, not gated: host timing is noisy). Returns the bf16 runs' K1
    and K2 launches. The continuous trace runs in ``phase_async``."""
    import dataclasses

    from repro_torch.bench import obs_overhead_gate
    from repro_torch.bench import serve_continuous as sc
    from repro_torch.kernels import ops

    PREFIX_DIR.mkdir(parents=True, exist_ok=True)
    V = cfg.vocab_size
    L = cfg.num_layers
    total = {"paged_attention": 0, "flash_attention": 0}

    def counted(fn, *a, **kw):
        ops.reset_launch_counts()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        return out, counts

    ptrace, geom = sc.prefix_share_trace(False)
    runs = {}
    for warm in (False, True):
        tag = "warm" if warm else "cold"
        run, counts = counted(
            sc.prefix_share_run, cfg, params, ptrace, geom, warm,
            device=dev, trace_path=str(PREFIX_DIR / f"TRACE_{tag}.json"))
        _check_serve_run(run, f"prefix/{tag}", len(ptrace), V)
        if counts["paged_attention"] == 0:
            raise SystemExit(f"[prefix] {tag}: K1 was not launched")
        if counts["flash_attention"] < L * run["stats"]["prefills"]:
            raise SystemExit(f"[prefix] {tag}: K2 launches "
                             f"{counts['flash_attention']} < {L} x "
                             f"{run['stats']['prefills']} prefills")
        log(f"[prefix] {tag} launches {counts}")
        for k in total:
            total[k] += counts[k]
        runs[tag] = run
    st = runs["warm"]["stats"]
    if not (st["prefix_hits"] > 0 and st["prefix_tokens_saved"] > 0
            and st["cow_forks"] > 0):
        raise SystemExit(f"[prefix] warm run: hits {st['prefix_hits']}, "
                         f"saved {st['prefix_tokens_saved']}, forks "
                         f"{st['cow_forks']}: the cache did not serve")
    for name, val, derived in sc.prefix_share_rows(runs["cold"],
                                                   runs["warm"], geom):
        log(f"[prefix] {name},{val},{derived}")
    cold_t = [o.tolist() for o in runs["cold"]["outs"]]
    warm_t = [o.tolist() for o in runs["warm"]["outs"]]
    same = sum(a == b for a, b in zip(cold_t, warm_t))
    msg = f"[prefix] bf16 L={L}: warm tokens equal cold on {same} of " \
          f"{len(cold_t)} requests"
    flips = [i for i, (a, b) in enumerate(zip(cold_t, warm_t)) if a != b]
    if flips:
        i = flips[0]
        msg += f"; first flip request {i}: " + _first_flip_margin(
            cfg, params, ptrace[i][1], cold_t[i], warm_t[i], dev)
    log(msg)
    del runs
    gc.collect()

    # fp32 compute at full width and PREFIX_FP32_LAYERS layers: the warm
    # pass must emit the cold pass's tokens exactly, and the cold pass on
    # the eager chunk the captured chunk's
    L32 = min(PREFIX_FP32_LAYERS, L)
    c32 = dataclasses.replace(cfg, compute_dtype="float32", num_layers=L32)
    p32 = _fp32_params(params, L32)
    outs = {}
    for warm in (False, True, "eager"):
        run = sc.prefix_share_run(c32, p32, ptrace, geom, warm is True,
                                  device=dev,
                                  chunk_graph=warm != "eager")
        name = {False: "cold", True: "warm", "eager": "cold-eager"}[warm]
        _check_serve_run(run, f"prefix/fp32-{name}", len(ptrace), V)
        outs[warm] = [o.tolist() for o in run["outs"]]
        if warm is True:
            st32 = run["stats"]
    if outs["eager"] != outs[False]:
        raise SystemExit(f"[prefix] fp32 L={L32}: the cold pass's tokens on "
                         "the captured chunk differ from the eager chunk's")
    log(f"[prefix] fp32 L={L32}: cold pass on the captured chunk equals "
        f"the eager chunk on all {len(ptrace)} requests")
    if outs[True] != outs[False]:
        bad = [i for i, (a, b) in enumerate(zip(outs[False], outs[True]))
               if a != b]
        raise SystemExit(f"[prefix] fp32 L={L32}: warm "
                         f"tokens differ from cold on requests {bad}")
    log(f"[prefix] fp32 L={L32}: warm tokens equal cold on "
        f"all {len(ptrace)} requests (hits {st32['prefix_hits']}, saved "
        f"{st32['prefix_tokens_saved']}, forks {st32['cow_forks']})")
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    g = obs_overhead_gate.measure(quick=True, device=dev)
    log(f"[prefix] obs_gate (smoke config, best of {g['reps']}): off "
        f"{g['off']:.1f} tok/s, on {g['on']:.1f} tok/s, on/off "
        f"{g['ratio']:.4f} on {card}")
    return total


# ------------------------------------------------------------------ phase 5b
#: requests of the trace each async-phase engine warms up on
ASYNC_WARM = 16
#: the async phase's modes: (name, engine arguments)
ASYNC_MODES = (("eager-sync", {"chunk_graph": False}),
               ("graph-sync", {}),
               ("graph-async", {"async_decode": True}))


@contextlib.contextmanager
def _sync_tally():
    """Count the stream and device synchronisations PyTorch makes while
    the block runs (``set_sync_debug_mode("warn")``: blocking copies,
    ``.item()``, ``synchronize``; waits on an event are not among them), by
    the innermost function of the serve engine on the stack."""
    import traceback
    import warnings
    tally = {}

    def show(message, category, filename, lineno, file=None, line=None):
        site = "other"
        for f in reversed(traceback.extract_stack()):
            if f.filename.endswith(os.path.join("serve", "engine.py")):
                site = f.name
                break
        tally[site] = tally.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield tally
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _mode_numbers(run) -> dict:
    """tok/s, TTFT and admission p50/p99 (ms) and the mean cycle split (ms)
    of one measured serve run."""
    m = run["obs"].metrics
    tokens = sum(len(o) for o in run["outs"])
    ttft, adm = m.get("serve.ttft_s"), m.get("bench.admission_latency_s")
    out = {"tok_per_s": tokens / run["dt"]}
    for q in (50, 99):
        out[f"ttft_p{q}"] = 1e3 * ttft.percentile(q)
        out[f"admission_p{q}"] = 1e3 * adm.percentile(q)
    for k in ("cycle", "dispatch", "chunk_sync", "book", "gap"):
        h = m.get(f"engine.{k}_s").summary()
        out[k] = 1e3 * h["mean"]
    out["cycles"] = m.get("engine.cycle_s").summary()["count"]
    # the "growth" span: copy-on-write guard, the streamed prefill window's
    # launch (and, sync, its completion) and table growth, per cycle
    grow = [e - b for name, track, b, e, _ in run["obs"].tracer.spans()
            if name == "growth" and track == "engine"]
    out["growth"] = 1e3 * sum(grow) / max(1, out["cycles"])
    return out


def phase_async(dev, cfg, params, chunk_ms: dict, card: str) -> dict:
    """The continuous trace of the serve suite (``choice`` lengths
    16/24/32, 32 new tokens, chunk 8, block 8, a 16-token window, Poisson
    at 20 Hz, PREFIX_N_REQ requests) in the three ASYNC_MODES. In fp32
    compute at full width and PREFIX_FP32_LAYERS layers: the captured
    chunk's tokens must equal the eager chunk's and the async engine's the
    sync engine's, and PyTorch's stream syncs are counted by engine
    function. At full width and depth in bf16 (``params``): one warmed
    engine per mode, two rounds in turns (eager, graph, async, then
    backwards), each run held to ``_check_serve_run`` and
    its launches counted; tok/s, TTFT and admission p50/p99 and the mean
    cycle split per mode (medians over the rounds: host time varies run to
    run), async-vs-sync token equality reported.
    ``chunk_ms``: the serve phase's chunk device times, printed beside.
    Returns the bf16 runs' K1 and K2 launches."""
    import dataclasses

    from repro_torch.bench import serve_continuous as sc
    from repro_torch.kernels import ops

    PREFIX_DIR.mkdir(parents=True, exist_ok=True)
    V, L = cfg.vocab_size, cfg.num_layers
    rng = np.random.default_rng(0)
    sizes = sc._sample_lens(rng, PREFIX_N_REQ, "choice", False)
    trace = sc._trace(rng, sizes, 20.0, 32)

    L32 = min(PREFIX_FP32_LAYERS, L)
    c32 = dataclasses.replace(cfg, compute_dtype="float32", num_layers=L32)
    p32 = _fp32_params(params, L32)
    toks32, syncs = {}, {}
    # each engine warms up on the trace's first ASYNC_WARM requests (every
    # prompt length, a saturating burst) rather than on all of them
    warm = trace[:ASYNC_WARM]
    for name, kw in ASYNC_MODES:
        eng, obs = sc.continuous_engine(c32, p32, warm, chunk=8,
                                        device=dev, **kw)
        with eng:
            with _sync_tally() as tally:
                run = sc.measured_run(eng, obs, trace)
        _check_serve_run(run, f"async/fp32-{name}", PREFIX_N_REQ, V)
        toks32[name] = [o.tolist() for o in run["outs"]]
        cyc = max(1, run["stats"]["decode_cycles"])
        syncs[name] = {k: round(v / cyc, 3) for k, v in
                       sorted(tally.items(), key=lambda kv: -kv[1])}
        log(f"[async] fp32 L={L32} {name}: stream syncs per decode cycle "
            f"by engine function {syncs[name]} (the measured run, {cyc} "
            f"decode cycles)")
    if toks32["graph-sync"] != toks32["eager-sync"]:
        raise SystemExit(f"[async] fp32 L={L32}: captured-chunk tokens "
                         "differ from the eager chunk's")
    if toks32["graph-async"] != toks32["graph-sync"]:
        bad = [i for i, (a, b) in enumerate(zip(toks32["graph-sync"],
                                                toks32["graph-async"]))
               if a != b]
        raise SystemExit(f"[async] fp32 L={L32}: async tokens differ from "
                         f"sync on requests {bad}")
    log(f"[async] fp32 L={L32}: eager-sync, graph-sync and graph-async "
        f"tokens equal on all {PREFIX_N_REQ} requests")
    del p32
    gc.collect()

    engines = {}
    for name, kw in ASYNC_MODES:
        t0 = time.perf_counter()
        engines[name] = sc.continuous_engine(cfg, params, warm, chunk=8,
                                             device=dev, **kw)
        log(f"[async] {name}: engine built and warmed in "
            f"{time.perf_counter() - t0:.1f}s")
    total = {"paged_attention": 0, "flash_attention": 0}
    nums = {name: [] for name, _ in ASYNC_MODES}
    toks = {}
    order = [n for n, _ in ASYNC_MODES]
    try:
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                eng, obs = engines[name]
                ops.reset_launch_counts()
                run = sc.measured_run(
                    eng, obs, trace,
                    str(PREFIX_DIR / f"TRACE_{name}.json") if rnd else None)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                _check_serve_run(run, f"async/{name}", PREFIX_N_REQ, V)
                st = run["stats"]
                if counts["paged_attention"] != L * st["decode_cycles"] * 8 \
                        or counts["flash_attention"] < L * st["prefills"]:
                    raise SystemExit(
                        f"[async] {name} launches {counts}: K1 != {L} x "
                        f"{st['decode_cycles']} chunks of 8 or K2 < {L} x "
                        f"{st['prefills']} prefills")
                for k in total:
                    total[k] += counts[k]
                n = _mode_numbers(run)
                nums[name].append(n)
                toks.setdefault(name, [o.tolist() for o in run["outs"]])
                log(f"[async] round {rnd} {name}: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in n.items())
                    + f" | launches {counts} | stats {st} on {card}")
                if rnd == 0 and name == "graph-sync":
                    for row in sc.continuous_rows(run, sizes, "choice"):
                        log(f"[async] {','.join(row)}")
    finally:
        for eng, _ in engines.values():
            eng.close()
    summary = {}
    for name, _ in ASYNC_MODES:
        runs = nums[name]
        summary[name] = {k: float(np.median([r[k] for r in runs]))
                         for k in runs[0]}
        log(f"[async] {name} (median of {len(runs)} runs in turns, bf16 "
            f"L={L}): " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in summary[name].items()))
    same = sum(a == b for a, b in zip(toks["graph-sync"],
                                      toks["graph-async"]))
    same_e = sum(a == b for a, b in zip(toks["eager-sync"],
                                        toks["graph-sync"]))
    log(f"[async] bf16 L={L}: graph-async tokens equal graph-sync on "
        f"{same} of {PREFIX_N_REQ} requests, graph-sync equal eager-sync on "
        f"{same_e}; the serve phase's chunk (8 steps, B=8): one replay "
        f"{chunk_ms['graph']['event_ms']:.3f} ms on the device (busy "
        f"{chunk_ms['graph']['busy_ms']:.3f} ms), eager busy "
        f"{chunk_ms['eager']['busy_ms']:.3f} ms on {card}")
    print(json.dumps({"async_modes": summary, "syncs_per_cycle": syncs,
                      "chunk_ms": chunk_ms, "card": card}), flush=True)
    return total


# ------------------------------------------------------------------ phase 5c
#: the slo phase's fault checks: stablelm at full width and SLO_FP32_LAYERS
#: layers in fp32 compute (the phase's fp32 idiom), its benign spec, the
#: isolation spec and the watchdog's budget and held read-back
SLO_FP32_LAYERS = 4
SLO_BENIGN = ("alloc_fail:p=0.05,seed=11;grow_fail:p=0.05,seed=11;"
              "preempt:every=5")
SLO_WATCHDOG_S = 1.0
SLO_LATENCY_MS = 4000
#: the fault checks' geometry and workload: 24 prompts of 3-16 tokens (one
#: 16-token window each), 9 new tokens (two chunks of 4). preempt:every=5
#: replays a paged row from its prompt, so a row alone must finish within
#: 4 cycles: the requests are sized for that
SLO_GEOM = dict(decode_chunk=4, prefill_chunk=16, max_batch=4, kv_blocks=20,
                block_size=4, max_admit=2)
SLO_NEW = 9
SLO_MODES = (("graph-sync", {}), ("graph-async", {"async_decode": True}))


def _slo_prompts(vocab: int, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(s)).astype(np.int32)
            for s in rng.integers(3, 17, size=n)]


def _settled(eng, tag: str) -> None:
    """Every slot free, nothing in flight, and (paged) every block free
    and past the fence, once the engine goes idle."""
    t0 = time.perf_counter()
    while not (eng._pipeline is None or eng._pipeline.idle()) \
            and time.perf_counter() - t0 < 60:
        time.sleep(0.01)
    B = len(eng._slot_req)
    if len(eng._free_slots) != B or any(r is not None for r in eng._slot_req) \
            or eng._inflight or eng._slots_reserved:
        raise SystemExit(f"[{tag}] slots still held: {len(eng._free_slots)} "
                         f"free of {B}")
    if eng.paged:
        pool = eng._pool
        parked = eng._prefix.num_parked if eng._prefix is not None else 0
        if pool.num_free + parked != pool.num_blocks - 1 \
                or pool.num_deferred:
            raise SystemExit(f"[{tag}] blocks leaked: {pool.num_free} free "
                             f"of {pool.num_blocks - 1}, "
                             f"{pool.num_deferred} deferred")


def _slo_outcomes(run, vocab: int, tag: str) -> dict:
    """Every submitted request ended with in-vocab tokens or a typed
    ServeError; returns the tally by tier and outcome."""
    from repro_torch.serve.errors import ServeError
    tally = {}
    for r, res in run["outcomes"]:
        if isinstance(res, ServeError):
            kind = type(res).__name__
        elif isinstance(res, np.ndarray) and res.ndim == 1 and len(res) \
                and ((res >= 0) & (res < vocab)).all():
            kind = "tokens"
        else:
            raise SystemExit(f"[{tag}] request {r.id}: bad outcome {res!r}")
        key = f"tier{r.priority}"
        tally.setdefault(key, {}).setdefault(kind, 0)
        tally[key][kind] += 1
    return tally


def phase_slo(dev, cfg, params, card: str) -> dict:
    """SLO overload control and per-row fault isolation of the engine on
    the captured chunk. The ``serve_slo`` suite (``bench/serve_slo.py``) at
    the reference's non-quick shapes with ``params`` (stablelm-1.6b at full
    width and depth, bf16), one warmed engine per mode and two rounds in
    turns (graph-sync, graph-async, then backwards): per run the
    tier-0 TTFT p50/p99 alone and under the flood and their p99 ratio
    (reported, not asserted, as in the reference), the shed / expired /
    preempted counts, the outcomes by tier; contended ``shed + expired >
    0`` is asserted, every future ends with in-vocab tokens or a typed
    ServeError and every slot and block ends free. Then, in fp32 compute at
    full width and SLO_FP32_LAYERS layers, in both graph modes: the benign
    spec keeps every request's tokens the fault-free engine's;
    ``chunk_sync_exc`` fails seated rows typed ``RowFailed`` and the one
    capture keeps replaying (later tokens a fresh engine's, the pool free);
    ``chunk_latency`` past ``watchdog_s`` fails a request typed
    ``WatchdogTimeout`` within about twice the budget. Returns the suite
    runs' K1 and K2 launches."""
    import dataclasses

    from repro_torch.bench import serve_slo
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.errors import RowFailed, WatchdogTimeout
    from repro_torch.serve.faultinject import FaultInjected

    V, L = cfg.vocab_size, cfg.num_layers
    work = serve_slo.slo_workload(False)
    total = {"paged_attention": 0, "flash_attention": 0}
    engines = {}
    for name, kw in SLO_MODES:
        t0 = time.perf_counter()
        engines[name] = serve_slo.slo_engine(cfg, params, work, device=dev,
                                             **kw)
        if engines[name][0]._chunk.graph is None:
            raise SystemExit(f"[slo] {name}: the chunk is not captured")
        log(f"[slo] {name}: engine built and warmed in "
            f"{time.perf_counter() - t0:.1f}s")
    summary = {name: [] for name, _ in SLO_MODES}
    order = [n for n, _ in SLO_MODES]
    try:
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                eng, obs = engines[name]
                runs = {}
                for which, trace in (("uncontended", work["t0"]),
                                     ("contended", work["merged"])):
                    tag = f"slo/{name}/{which}/round {rnd}"
                    ops.reset_launch_counts()
                    run = serve_slo.slo_run(eng, obs, trace)
                    torch.cuda.synchronize()
                    counts = ops.launch_counts()
                    _settled(eng, tag)
                    tally = _slo_outcomes(run, V, tag)
                    st = run["stats"]
                    if counts["paged_attention"] != \
                            L * st["decode_cycles"] * eng.decode_chunk \
                            or counts["flash_attention"] < L * st["prefills"] \
                            or not counts["paged_attention"]:
                        raise SystemExit(
                            f"[{tag}] launches {counts}: K1 != {L} x "
                            f"{st['decode_cycles']} chunks of "
                            f"{eng.decode_chunk} or K2 < {L} x "
                            f"{st['prefills']} prefills")
                    for k in total:
                        total[k] += counts[k]
                    runs[which] = (run, tally)
                    # each tier-0 request: (prompt tokens, TTFT ms, of it
                    # the wait before admission ms), by TTFT
                    ttft0 = [(r.prompt_len, round(1e3 * r.ttft, 1),
                              round(1e3 * (r.admitted_at - r.submitted_at),
                                    1))
                             for r, _ in run["outcomes"]
                             if r.priority == 0 and r.ttft]
                    log(f"[{tag}]: {run['dt']:.3f}s, outcomes {tally}, "
                        f"submit rejections {run['shed']}, launches {counts}"
                        f" | tier-0 (prompt, TTFT ms, admission wait ms) "
                        f"{sorted(ttft0, key=lambda x: x[1])} | "
                        f"{_cycle_split(obs)} | stats {st} on {card}")
                (base, _), (cont, tally) = runs["uncontended"], \
                    runs["contended"]
                for row in serve_slo.slo_rows(base, cont, work):
                    log(f"[slo] {name} round {rnd}: {','.join(row)}")
                st = cont["stats"]
                if st["shed"] + st["expired"] <= 0:
                    raise SystemExit(
                        f"[slo] {name} round {rnd}: contended shed + expired"
                        " = 0: the overload controls never engaged")
                b, c = base["ttft0"], cont["ttft0"]
                ttft1 = cont["ttft1"]
                summary[name].append({
                    "tier0_ttft_p50_ms": [1e3 * b["p50"], 1e3 * c["p50"]],
                    "tier0_ttft_p99_ms": [1e3 * b["p99"], 1e3 * c["p99"]],
                    "p99_ratio": c["p99"] / max(b["p99"], 1e-9),
                    "shed": st["shed"], "expired": st["expired"],
                    "preempted": st["preempted"], "stalls": st["stalls"],
                    "completed": cont["done"],
                    "failed_typed": cont["failed"],
                    "tier1_ttft_p50_ms": (1e3 * ttft1["p50"] if ttft1
                                          and ttft1["count"] else None),
                    "outcomes": tally, "contended_s": cont["dt"]})
                log(f"[slo] {name} round {rnd} (bf16 L={L}): tier-0 TTFT "
                    f"p50 {1e3 * b['p50']:.1f} -> {1e3 * c['p50']:.1f} ms, "
                    f"p99 {1e3 * b['p99']:.1f} -> {1e3 * c['p99']:.1f} ms "
                    f"(contended/uncontended p99 "
                    f"{summary[name][-1]['p99_ratio']:.2f}x, target <= 2x, "
                    f"reported), shed {st['shed']}, expired "
                    f"{st['expired']}, preempted {st['preempted']} on {card}")
    finally:
        for eng, _ in engines.values():
            eng.close()
    del engines
    gc.collect()

    # fault checks in fp32 compute at full width and SLO_FP32_LAYERS layers
    L32 = min(SLO_FP32_LAYERS, L)
    c32 = dataclasses.replace(cfg, compute_dtype="float32", num_layers=L32)
    p32 = _fp32_params(params, L32)
    prompts = _slo_prompts(V, 24)
    later = _slo_prompts(V, 4, seed=1)

    def serve(ps, **kw):
        with ServeEngine(c32, p32, device=dev, **SLO_GEOM, **kw) as eng:
            outs = [o.tolist() for o in eng.generate(ps, SLO_NEW)]
            _settled(eng, f"slo/fp32 {kw}")
            return outs, eng

    want, _ = serve(prompts)
    want_later, _ = serve(later)
    for name, kw in SLO_MODES:
        got, eng = serve(prompts, fault_inject=SLO_BENIGN, **kw)
        fires = eng._fi.counts()
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
            raise SystemExit(f"[slo] fp32 L={L32} {name}: benign faults "
                             f"changed the tokens of requests {bad}")
        if eng.stats["preempted"] == 0:
            raise SystemExit(f"[slo] {name}: no preemption under "
                             f"{SLO_BENIGN}: {fires}")
        log(f"[slo] fp32 L={L32} {name}: {SLO_BENIGN} keeps all "
            f"{len(prompts)} requests' tokens (fires {fires}; preempted "
            f"{eng.stats['preempted']}, stalls {eng.stats['stalls']})")

        eng = ServeEngine(c32, p32, device=dev, **SLO_GEOM,
                          fault_inject="chunk_sync_exc:at=3", **kw)
        with eng:
            graph, ptrs = eng._chunk.graph, eng._chunk._pointers()
            failed = 0
            for r in [eng.submit(p, SLO_NEW) for p in prompts[:6]]:
                try:
                    out = r.result(timeout=120.0)
                    if not ((out >= 0) & (out < V)).all():
                        raise SystemExit(f"[slo] bad tokens {out}")
                except RowFailed as e:
                    if not isinstance(e.__cause__, FaultInjected):
                        raise SystemExit(f"[slo] {name}: RowFailed caused "
                                         f"by {e.__cause__!r}")
                    failed += 1
            replays = eng._chunk.replays
            got = [o.tolist() for o in eng.generate(later, SLO_NEW)]
            if not failed or eng._broken is not None \
                    or eng._reset_epoch != 1:
                raise SystemExit(f"[slo] {name}: isolation failed {failed} "
                                 f"rows, broken {eng._broken!r}")
            if eng._chunk.graph is not graph \
                    or eng._chunk._pointers() != ptrs \
                    or eng._chunk.replays <= replays:
                raise SystemExit(f"[slo] {name}: the capture did not keep "
                                 "replaying after the reset")
            _settled(eng, f"slo/isolation/{name}")
            if got != want_later:
                raise SystemExit(f"[slo] {name}: tokens after the reset "
                                 "differ from a fresh engine's")
            log(f"[slo] fp32 L={L32} {name}: chunk_sync_exc:at=3 failed "
                f"{failed} rows typed RowFailed (row_failures "
                f"{eng.stats['row_failures']}), one capture kept replaying "
                f"({replays} -> {eng._chunk.replays}), {len(later)} later "
                f"requests equal a fresh engine's, all "
                f"{eng._pool.num_blocks - 1} blocks free")

    # the watchdog, with a replay in flight and the read-back held
    eng = ServeEngine(c32, p32, device=dev, **SLO_GEOM,
                      watchdog_s=SLO_WATCHDOG_S, async_decode=True,
                      fault_inject=f"chunk_latency:at=2,ms={SLO_LATENCY_MS}")
    with eng:
        r = eng.submit(prompts[0], 40)
        t0 = time.perf_counter()
        try:
            r.result(timeout=60.0)
            raise SystemExit("[slo] the watchdog did not fire")
        except WatchdogTimeout:
            waited = time.perf_counter() - t0
        if waited > 2.5 * SLO_WATCHDOG_S or eng.stats["watchdog_fires"] != 1:
            raise SystemExit(f"[slo] watchdog: raised after {waited:.3f}s "
                             f"(budget {SLO_WATCHDOG_S}s)")
        log(f"[slo] watchdog: chunk_latency {SLO_LATENCY_MS} ms past "
            f"watchdog_s {SLO_WATCHDOG_S}: WatchdogTimeout after "
            f"{waited:.3f}s")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"slo_modes": summary, "card": card}), flush=True)
    return total


def phase_slot_preempt(dev, cfg, tag: str, layers: int) -> dict:
    """Checkpoint preemption of a slot-state arch (falcon-mamba, zamba2):
    in fp32 compute at full width and ``layers`` layers (seeded random
    weights), ``preempt:every=3`` on the synchronous captured-chunk engine
    copies each preempted slot's state to host memory and re-seats it: the
    tokens must equal the fault-free run's, with preemptions and one
    prefill per request. Returns the run's launch counts."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine

    c32 = dataclasses.replace(cfg, compute_dtype="float32", num_layers=layers)
    p32 = init_params(c32, torch.Generator(dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (7, 16, 24)]
    geom = dict(decode_chunk=2, max_batch=2, max_seq_len=64)
    outs = {}
    for spec in (None, "preempt:every=3"):
        ops.reset_launch_counts()
        with ServeEngine(c32, p32, device=dev, fault_inject=spec,
                         **geom) as eng:
            outs[spec] = [o.tolist() for o in eng.generate(prompts, 24)]
            _settled(eng, f"{tag}/preempt")
            stats = dict(eng.stats)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    if outs[None] != outs["preempt:every=3"]:
        raise SystemExit(f"[{tag}] checkpoint preemption changed tokens")
    if stats["preempted"] == 0 or stats["prefills"] != len(prompts):
        raise SystemExit(f"[{tag}] preempted {stats['preempted']}, prefills "
                         f"{stats['prefills']}: no checkpoint preemption")
    log(f"[{tag}] fp32 L={layers} checkpoint preemption (preempt:every=3, "
        f"graph-sync): {stats['preempted']} preemptions, "
        f"{stats['prefills']} prefills for {len(prompts)} requests, tokens "
        f"equal the fault-free run's; launches {counts}")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ phase 5d
#: the durable phase's state files and its kill-and-recover runs
DURABLE_DIR = Path("build") / "durable"
#: its fp32 checks (the restored replay, kill and recover) cut stablelm to
#: its first 4 layers at full width
DURABLE_FP32_LAYERS = 4
#: the drain-deadline check: new tokens a request asks for (enough that
#: rows are still seated when the deadline passes) and the deadline
DRAIN_MAX_NEW = 160
DRAIN_DEADLINE_S = 0.02


def _durable_procs(argvs):
    """Run ``repro_torch.launch.incarnation`` once per argument list, all
    at once on the card; returns their (rc, stdout, stderr)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src")}
    procs = [subprocess.Popen([sys.executable, "-m",
                               "repro_torch.launch.incarnation", *a],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    out = []
    for pr in procs:
        try:
            o, e = pr.communicate(timeout=300)
        finally:
            pr.kill()
        out.append((pr.returncode, o, e))
    return out


def _parse_durable(stdout):
    done, replayed = {}, {}
    for line in stdout.splitlines():
        parts = line.split()
        if parts and parts[0] in ("DONE", "REPLAYED"):
            (done if parts[0] == "DONE" else replayed)[int(parts[1])] = \
                [int(t) for t in parts[2].split(",")]
    return done, replayed


def _first_ttft(eng, prompt, max_new: int):
    """(tokens, TTFT s) of one request submitted to an idle engine."""
    r = eng.submit(prompt, max_new)
    out = eng.result(r, timeout=300.0)
    return out, r.first_token_at - r.submitted_at


def phase_durable(dev, cfg, params, card: str) -> dict:
    """Durable serving on the card (``ServeEngine.drain``, ``snapshot``,
    ``restore``, ``recover``; the journal). With ``params`` (stablelm-1.6b
    at full width and depth, bf16), the paged engine with the prefix cache
    and the captured chunk, synchronous and async: serve the prefix-share
    trace, ``drain()`` and ``snapshot()`` (bytes, seconds, the host bytes
    the block-only copy moved against the whole pool's); a
    fresh engine, its chunk captured in the constructor, ``restore()``s it
    (seconds) with ``_pkv.data_ptr()`` and the graph unchanged, and its
    first request of a known prefix hits warm (``prefix.warm_hits``), its
    TTFT beside a fresh cold engine's; a flipped byte raises
    ``SnapshotCorrupt`` and ``recover()`` starts cold with the cold
    engine's tokens. In fp32 at full width and DURABLE_FP32_LAYERS layers:
    a restored engine's replays give a fresh engine's tokens;
    ``drain(deadline_s=DRAIN_DEADLINE_S)`` with rows seated preempts them
    through the sweep's drain branch (sync and async), the snapshot queues
    every unfinished request, ``close()`` fails them typed, and a restored
    engine resubmitting the queue gives an uninterrupted run's tokens; a
    subprocess on the card (``repro_torch.launch.incarnation``) killed by
    ``crash_at:at=3`` (rc 137), sync and async side by side, and a fresh
    process that recovers replays every unfinished request with an
    uncrashed run's tokens. Then ``journal_gate`` at ``--quick``: its rows
    and each mode's prefill groups; over its 5% budget it raises.
    Returns the bf16 runs' K1 and K2 launches."""
    import dataclasses
    import shutil

    from repro_torch.bench import journal_gate
    from repro_torch.bench import serve_continuous as sc
    from repro_torch.kernels import ops
    from repro_torch.launch import incarnation
    from repro_torch.obs import Observability
    from repro_torch.serve.engine import SNAPSHOT_FILE, ServeEngine
    from repro_torch.serve.errors import ServeError, SnapshotCorrupt
    from repro_torch.serve.snapshot import corrupt_snapshot, read_snapshot

    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    DURABLE_DIR.mkdir(parents=True)
    V = cfg.vocab_size
    ptrace, geom = sc.prefix_share_trace(False)
    max_new = max(mn for _, _, mn in ptrace)
    kw = dict(decode_chunk=geom["chunk"], block_size=8, prefill_chunk=16,
              kv_blocks=geom["kv_blocks"], prefix_cache=True, device=dev,
              max_seq_len=-(-(max(len(p) for _, p, _ in ptrace) + max_new)
                            // 8) * 8)
    first = ptrace[0][1]
    total = {"paged_attention": 0, "flash_attention": 0}
    numbers = {}

    def check(out, tag):
        if out.ndim != 1 or len(out) != max_new \
                or not ((out >= 0) & (out < V)).all():
            raise SystemExit(f"[durable] {tag}: bad output {out}")

    for mode, extra in (("sync", {}), ("async", {"async_decode": True})):
        tag = f"durable/{mode}"
        sdir = DURABLE_DIR / mode
        sdir.mkdir()
        snap = str(sdir / SNAPSHOT_FILE)
        ops.reset_launch_counts()
        obs = Observability()
        with ServeEngine(cfg, params, obs=obs, **kw, **extra) as eng:
            _, outs, dt = sc._replay(eng, ptrace, obs)
            for o in outs:
                check(o, tag)
            if not eng.drain(timeout=60.0):       # the trace is served
                raise SystemExit(f"[{tag}] drain did not settle")
            t0 = time.perf_counter()
            nbytes = eng.snapshot(snap)
            t_snap = time.perf_counter() - t0
            pool_bytes = eng._pkv.numel() * eng._pkv.element_size()
            hits = eng.stats["prefix_hits"]
        meta, arrays = read_snapshot(snap)
        moved = arrays["prefix_pages"].nbytes
        with ServeEngine(cfg, params, **kw, **extra) as cold:
            c_out, c_ttft = _first_ttft(cold, first, max_new)
        wobs = Observability()
        with ServeEngine(cfg, params, obs=wobs, **kw, **extra) as warm:
            graph, ptr = warm._chunk.graph, warm._pkv.data_ptr()
            t0 = time.perf_counter()
            warm.restore(snap)
            t_restore = time.perf_counter() - t0
            if warm._pkv.data_ptr() != ptr or warm._chunk.graph is not graph:
                raise SystemExit(f"[{tag}] restore moved the pool or "
                                 "re-captured the chunk")
            replays = warm._chunk.replays
            w_out, w_ttft = _first_ttft(warm, first, max_new)
            whits = wobs.metrics.get("prefix.warm_hits").value
            if whits < 1 or (graph is not None
                             and warm._chunk.replays <= replays):
                raise SystemExit(f"[{tag}] first request after restore: "
                                 f"warm hits {whits}, replays "
                                 f"{warm._chunk.replays - replays}")
            warm_started = warm.stats["warm_started"]
        check(c_out, tag)
        check(w_out, tag)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k in total:
            total[k] += counts[k]
        if counts["paged_attention"] == 0 or counts["flash_attention"] == 0:
            raise SystemExit(f"[{tag}] K1/K2 not launched: {counts}")
        same = w_out.tolist() == c_out.tolist()
        log(f"[{tag}] {len(ptrace)} prefix-share requests in {dt:.3f}s "
            f"({hits} hits); snapshot {nbytes} bytes "
            f"in {t_snap:.3f}s ({len(meta['prefix'])} nodes, {moved} host "
            f"bytes moved against the whole pool's {pool_bytes}); restore "
            f"{t_restore:.3f}s, {warm_started} warm nodes, pool address "
            f"and graph unchanged; first request TTFT warm "
            f"{w_ttft * 1e3:.2f} ms against cold {c_ttft * 1e3:.2f} ms "
            f"(warm hits {whits}; bf16 tokens warm == cold: {same}); "
            f"launches {counts} on {card}")
        numbers[mode] = {"snapshot_bytes": nbytes, "snapshot_s": t_snap,
                         "host_bytes": moved, "pool_bytes": pool_bytes,
                         "restore_s": t_restore,
                         "ttft_warm_ms": w_ttft * 1e3,
                         "ttft_cold_ms": c_ttft * 1e3}
        if mode == "sync":
            # a flipped byte: typed, and recover() starts cold with the
            # cold engine's tokens
            bad = DURABLE_DIR / "corrupt"
            bad.mkdir()
            shutil.copy(snap, bad / SNAPSHOT_FILE)
            corrupt_snapshot(str(bad / SNAPSHOT_FILE))
            with ServeEngine(cfg, params, **kw) as eng:
                try:
                    eng.restore(str(bad / SNAPSHOT_FILE))
                    raise SystemExit("[durable] a flipped byte restored")
                except SnapshotCorrupt as e:
                    why = str(e)
                eng.recover(str(bad))
                out, _ = _first_ttft(eng, first, max_new)
                if eng.stats["warm_started"] or \
                        out.tolist() != c_out.tolist():
                    raise SystemExit("[durable] corrupt snapshot: not a "
                                     "cold start with the cold tokens")
            log(f"[durable] flipped byte: SnapshotCorrupt ({why}); "
                "recover() started cold with the cold engine's tokens")

    # fp32 at full width and DURABLE_FP32_LAYERS layers: a restored engine
    # replays with a fresh engine's tokens
    L32 = min(DURABLE_FP32_LAYERS, cfg.num_layers)
    c32 = dataclasses.replace(cfg, compute_dtype="float32", num_layers=L32)
    p32 = _fp32_params(params, L32)
    prompts = [p for _, p, _ in ptrace[:8]]
    snap32 = str(DURABLE_DIR / "fp32.snap")
    with ServeEngine(c32, p32, **kw) as eng:
        eng.generate(prompts, max_new)
        eng.drain()
        eng.snapshot(snap32)
    with ServeEngine(c32, p32, **{**kw, "prefix_cache": False}) as fresh:
        want = [o.tolist() for o in fresh.generate(prompts, max_new)]
    for mode, extra in (("sync", {}), ("async", {"async_decode": True})):
        with ServeEngine(c32, p32, **kw, **extra) as eng:
            ptr = eng._pkv.data_ptr()
            eng.restore(snap32)
            got = [o.tolist() for o in eng.generate(prompts, max_new)]
            hits = eng._prefix.stats["warm_hits"]
            if eng._pkv.data_ptr() != ptr or got != want or hits < 1:
                raise SystemExit(f"[durable] fp32 L={L32} {mode}: restored "
                                 f"replay differs from a fresh engine "
                                 f"(warm hits {hits})")
        log(f"[durable] fp32 L={L32} {mode}: after restore ({hits} warm "
            f"hits) the captured chunk's replays give a fresh engine's "
            f"tokens on all {len(prompts)} requests")

    # a drain whose deadline passes with rows seated: the sweep's drain
    # branch preempts them under the captured chunk, the snapshot's queue
    # holds every unfinished request, close() fails them typed, and a
    # restored engine resubmitting the queue gives an uninterrupted run's
    # tokens
    dprompts = prompts[:4]
    dkw = {**kw, "kv_blocks": 192, "max_seq_len": -(-(max(
        len(p) for p in dprompts) + DRAIN_MAX_NEW) // 8) * 8}
    with ServeEngine(c32, p32, **{**dkw, "prefix_cache": False}) as fresh:
        dwant = [o.tolist() for o in fresh.generate(dprompts, DRAIN_MAX_NEW)]
    for mode, extra in (("sync", {}), ("async", {"async_decode": True})):
        dsnap = str(DURABLE_DIR / f"drain-{mode}.snap")
        with ServeEngine(c32, p32, **dkw, **extra) as eng:
            reqs = [eng.submit(p, DRAIN_MAX_NEW) for p in dprompts]
            while all(r.first_token_at is None for r in reqs):
                time.sleep(0.001)
            seated = sum(r is not None for r in eng._slot_req)
            t0 = time.perf_counter()
            if not eng.drain(deadline_s=DRAIN_DEADLINE_S, timeout=60.0):
                raise SystemExit(f"[durable] drain {mode}: not settled")
            t_drain = time.perf_counter() - t0
            preempted = eng.stats["drain_preempted"]
            eng.snapshot(dsnap)
        index = {r.id: i for i, r in enumerate(reqs)}
        done, lost = {}, set()
        for i, r in enumerate(reqs):
            try:
                done[i] = r.result(timeout=5.0).tolist()
            except ServeError:
                lost.add(i)
        meta, _ = read_snapshot(dsnap)
        queued = {index[d["id"]] for d in meta["queue"]}
        if preempted < 1 or queued != lost:
            raise SystemExit(f"[durable] drain {mode}: {preempted} rows "
                             f"preempted, queue {sorted(queued)}, failed "
                             f"typed at close {sorted(lost)}")
        with ServeEngine(c32, p32, **dkw, **extra) as eng:
            ptr = eng._pkv.data_ptr()
            again = {index[d["id"]]: eng.submit(d["prompt"], d["max_new"])
                     for d in eng.restore(dsnap)}
            for i, r in again.items():
                done[i] = eng.result(r).tolist()
            if eng._pkv.data_ptr() != ptr:
                raise SystemExit(f"[durable] drain {mode}: restore moved "
                                 "the pool")
        bad = [i for i in range(len(dprompts)) if done.get(i) != dwant[i]]
        if bad:
            raise SystemExit(f"[durable] drain {mode}: requests {bad} differ "
                             "from an uninterrupted run")
        log(f"[durable] fp32 L={L32} {mode}: drain(deadline_s="
            f"{DRAIN_DEADLINE_S}) with {seated} rows seated settled in "
            f"{t_drain:.3f}s, {preempted} preempted; the snapshot queued "
            f"{sorted(queued)} (failed typed at close), and a restored "
            f"engine resubmitting them gave an uninterrupted run's tokens "
            f"on all {len(dprompts)} requests")
        numbers[f"drain_{mode}"] = {"seated": seated, "preempted": preempted,
                                    "drain_s": t_drain}

    # the crash: an uncrashed oracle here, on the same weights; then a
    # crash_at process per mode side by side, then their recoveries
    with incarnation.engine(c32, p32, dev) as eng:
        oracle = [eng.result(r).tolist()
                  for r in [eng.submit(p, incarnation.MAX_NEW)
                            for p in incarnation.prompts(V)]]
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    argvs = [["--state-dir", str(DURABLE_DIR / f"crash-{m}"),
              "--layers", str(L32)] + a
             for m, a in (("sync", []), ("async", ["--async"]))]
    crashed = _durable_procs([a + ["--fault-inject", "crash_at:at=3"]
                              for a in argvs])
    recovered = _durable_procs([a + ["--no-submit"] for a in argvs])
    for (m, c, r) in zip(("sync", "async"), crashed, recovered):
        if c[0] != 137:
            raise SystemExit(f"[durable] crash_at {m}: rc {c[0]}\n"
                             f"{c[2][-3000:]}")
        if r[0] != 0 or not r[1].rstrip().endswith("EXIT CLEAN"):
            raise SystemExit(f"[durable] recover {m}: rc {r[0]}\n"
                             f"{r[2][-3000:]}")
        done, _ = _parse_durable(c[1])
        rdone, replayed = _parse_durable(r[1])
        if rdone or not replayed or set(done) & set(replayed):
            raise SystemExit(f"[durable] {m}: done {sorted(done)}, "
                             f"replayed {sorted(replayed)}")
        for i, want in enumerate(oracle):
            got = done.get(i) or replayed.get(i)
            if got != want:
                raise SystemExit(f"[durable] {m}: request {i} "
                                 f"{'lost' if got is None else 'diverged'}")
        log(f"[durable] fp32 L={L32} {m}: crash_at:at=3 exited 137 after "
            f"{sorted(done)} finished; the recovering process replayed "
            f"{sorted(replayed)} with the uncrashed run's tokens")
    log(f"[durable] kill and recover, 4 processes: "
        f"{time.perf_counter() - t0:.1f}s")

    # the gate at --quick: its rows, each mode's prefill groups and tok/s
    # quartiles, the per-pair ratios' quartiles and the threads alive in
    # this process (each can take the GIL a journal write releases); over
    # its budget it raises
    threads = threading.active_count()
    g = journal_gate.measure(quick=True, device=dev)
    q = {m: np.percentile(g["samples"][m], [25, 50, 75]).round().tolist()
         for m in ("off", "on")}
    pq = np.percentile(np.asarray(g["samples"]["on"])
                       / np.asarray(g["samples"]["off"]),
                       [25, 50, 75]).round(4).tolist()
    log(f"[durable] journal_gate (smoke config, --quick, {g['reps']} "
        f"off/on pairs, {g['records']} records, {threads} threads): tok/s "
        f"quartiles off {q['off']}, on {q['on']}; on/off quartiles {pq}; "
        f"prefill groups off {sorted(set(g['prefills']['off']))}, on "
        f"{sorted(set(g['prefills']['on']))} on {card}")
    for row in journal_gate.rows(g):
        log(f"[durable] {','.join(row)}")
    numbers["journal_gate_ratio"] = g["ratio"]
    log(json.dumps({"durable": numbers}))
    return total


# ------------------------------------------------------------------ phase 5e
#: the percall phase's shortened serve trace (the per-call arm serves one
#: request after another, eagerly, ~0.8-1 s each at full width; 24 until a
#: run on an H100 with a slow host took 63.4 s in this phase)
PERCALL_N_REQ = 12
#: its fp32 checks cut stablelm to its first 4 layers at full width
PERCALL_FP32_LAYERS = 4


def phase_percall(dev, cfg, params, card: str) -> dict:
    """The per-call contiguous-decode baseline on the card. In fp32 at full
    width and PERCALL_FP32_LAYERS layers: ``lm.decode_step`` from a
    contiguous ``lm.prefill`` cache against ``lm.decode_step_paged`` (K1)
    over the same KV scattered into a paged pool, per step (logits within
    STEP_REL_TOL, the same greedy tokens fed to both); and
    ``_generate_grouped``'s tokens equal to the resident engine's. Then the
    serve suite with its per-call arm (``bench/serve_continuous.py``) at
    the reference's non-quick shapes on a trace of PERCALL_N_REQ requests
    with ``params`` (bf16, full depth): its rows, per-call tok/s and
    latency p50/p99 beside the continuous engine's. Returns the suite's K1
    and K2 launches."""
    import dataclasses

    from repro_torch.bench import serve_continuous as sc
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import init_kv_pool, scatter_prefill_rows

    L32 = min(PERCALL_FP32_LAYERS, cfg.num_layers)
    c32 = dataclasses.replace(cfg, compute_dtype="float32", num_layers=L32)
    p32 = _fp32_params(params, L32)
    rng = np.random.default_rng(3)
    B, S, steps, bs = 4, 48, 8, 16
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, S))
                            .astype(np.int32)).to(dev)
    nb = -(-(S + steps) // bs)
    with torch.inference_mode():
        # one prefill feeds both: its contiguous cache, and a pool of
        # 1 + B x nb blocks holding the same KV (row b in blocks
        # 1 + b*nb ...)
        logits, cache = lm.prefill(c32, p32, toks, max_len=nb * bs)
        pool = init_kv_pool(c32, 1 + B * nb, bs, dev)
        tables = torch.arange(1, 1 + B * nb, dtype=torch.int32,
                              device=dev).reshape(B, nb)
        scatter_prefill_rows(pool, tables, cache["k"], cache["v"])
        cur = torch.argmax(logits, -1).to(torch.int32)
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        active = torch.ones(B, dtype=torch.bool, device=dev)
        layers = lm.layer_views(p32)
        for step in range(steps):
            lc, cache = lm.decode_step(c32, p32, cache, cur, layers=layers)
            lp, _ = lm.decode_step_paged(c32, p32, pool, tables, lengths,
                                         cur, active, impl="kernel",
                                         layers=layers)
            _compare(f"fp32 L={L32} decode_step vs decode_step_paged (K1) "
                     f"step {step}", lc.float(), lp.float(),
                     STEP_REL_TOL["float32"], tag="percall")
            cur = torch.argmax(lc, -1).to(torch.int32)
            lengths += 1
    del pool, cache
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (16, 24, 16, 32, 57, 24, 90, 32)]
    with ServeEngine(c32, p32, device=dev) as eng:
        res = [o.tolist() for o in eng.generate(prompts, MAX_NEW)]
        grp = [o.tolist() for o in eng._generate_grouped(prompts, MAX_NEW)]
    if grp != res:
        bad = [i for i, (a, b) in enumerate(zip(grp, res)) if a != b]
        raise SystemExit(f"[percall] fp32 L={L32}: _generate_grouped tokens "
                         f"differ from the resident engine's on {bad}")
    log(f"[percall] fp32 L={L32}: _generate_grouped tokens equal the "
        f"resident engine's on all {len(prompts)} requests")
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    sizes = sc._sample_lens(rng, PERCALL_N_REQ, "choice", False)
    trace = sc._trace(rng, sizes, 20.0, 32)
    ops.reset_launch_counts()
    run = sc.continuous_run(cfg, params, trace, chunk=8, device=dev)
    base = sc.percall_run(cfg, params, trace, chunk=8, device=dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for o in list(run["outs"]) + list(base["outs"]):
        if o.ndim != 1 or len(o) != 32 \
                or not ((o >= 0) & (o < cfg.vocab_size)).all():
            raise SystemExit(f"[percall] bad output {o}")
    rows = list(sc.continuous_rows(run, sizes, "choice", base))
    for name, val, derived in rows:
        log(f"[percall] {name},{val},{derived}")
    if counts["paged_attention"] == 0 \
            or counts["flash_attention"] < cfg.num_layers * PERCALL_N_REQ:
        raise SystemExit(f"[percall] launches {counts}: K1 or the per-call "
                         "prefills' K2 missing")
    val = {n: v for n, v, _ in rows}
    log(json.dumps({"percall": {k: float(val[k]) for k in (
        "serve_continuous_tok_per_s", "serve_continuous_p50_ms",
        "serve_continuous_p99_ms", "serve_percall_tok_per_s",
        "serve_percall_p50_ms", "serve_percall_p99_ms")}}))
    log(f"[percall] {PERCALL_N_REQ} requests: continuous {run['dt']:.3f}s, "
        f"per-call {base['dt']:.3f}s; launches {counts} on {card}")
    return counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other-csrc", type=Path, default=None, help=(
        "a directory of another tree's kernel sources (csrc/*.cu and "
        "common.cuh, e.g. the parent commit's); its K1, K3 and K3's "
        "backward are then built and timed in turns beside this tree's, as "
        "one more build of their ablations"))
    ap.add_argument("--k3bwd-ablations", action="store_true", help=(
        "also time copies of K3's backward with one part cut out "
        "(K3BWD_ABLATIONS) in turns beside it"))
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    t_phase = [t_start]

    def done(phase: str) -> None:   # each phase's seconds, for the budget
        now = time.perf_counter()
        log(f"[time] {phase} {now - t_phase[0]:.1f}s")
        t_phase[0] = now

    smi = phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    report = phase_kernels(dev, args.other_csrc)
    done("card, build, K1/K2")
    cfg, params, prompts, frozen, counts, chunk_ms = phase_serve(dev,
                                                                 card=smi)
    phase_steps(cfg, params, prompts, frozen, dev)
    del frozen
    done("stablelm serve and steps")
    acounts = phase_async(dev, cfg, params, chunk_ms, smi)
    done("async (continuous trace in three modes)")
    pcounts = phase_prefix(dev, cfg, params, smi)
    done("prefix (serve suite, prefix cache, obs)")
    scounts = phase_slo(dev, cfg, params, smi)
    done("slo (serve_slo suite, faults, isolation, watchdog)")
    dcounts = phase_durable(dev, cfg, params, smi)
    done("durable (drain, snapshot, restore, kill and recover, journal)")
    ccounts = phase_percall(dev, cfg, params, smi)
    del params
    gc.collect()              # free the serve phase's weights and pool
    torch.cuda.empty_cache()
    done("percall (decode_step, the per-call serve arm)")
    report["mamba_scan"] = phase_k3(dev, args.other_csrc)
    done("K3")
    mcfg, mparams, mprompts, mcounts = phase_serve_ssm(dev, card=smi)
    phase_steps_ssm(mcfg, mparams, mprompts, dev)
    del mparams
    mpre = phase_slot_preempt(dev, mcfg, "ssm", 4)
    gc.collect()              # free falcon-mamba's weights and slot pool
    torch.cuda.empty_cache()
    done("falcon-mamba serve and steps")
    zcfg, zparams, zprompts, zcounts = phase_serve_ssm(dev, "zamba2-1.2b",
                                                       "hybrid", smi)
    phase_steps_hybrid(zcfg, zparams, zprompts, dev)
    del zparams
    zpre = phase_slot_preempt(dev, zcfg, "hybrid", 8)
    gc.collect()              # free zamba2's weights and slot pool
    torch.cuda.empty_cache()
    done("zamba2 serve and steps")
    qcfg, qparams, qprompts, qfrozen, qcounts, _ = phase_serve(
        dev, "qwen2-moe-a2.7b", "moe", smi)
    phase_steps_moe(qcfg, qparams, qprompts, qfrozen, dev)
    del qparams, qfrozen
    gc.collect()              # free qwen2-moe's weights and frozen pool
    torch.cuda.empty_cache()
    done("qwen2-moe serve and steps")
    train = phase_train(dev, smi)
    done("train")
    report["mamba_scan_bwd"] = phase_k3bwd(dev, args.other_csrc,
                                           args.k3bwd_ablations)
    done("K3 backward")
    ssm_train = phase_train_ssm(dev, smi)
    done("train_ssm (zamba2-1.2b, falcon-mamba-7b at 16 layers)")
    front = phase_frontend(dev, smi)
    done("frontend (internvl2-1b training, musicgen-large serving)")
    train_counts = [ssm_train["zamba2-1.2b"]["counts"],
                    ssm_train["falcon-mamba-7b"]["counts"],
                    front["internvl2-1b"]["counts"],
                    front["musicgen-large"]["counts"]]
    torch.backends.cuda.matmul.allow_tf32 = False   # K4's plain version
    report["lsdnn_layer"] = phase_k4(dev)
    report["lsdnn_layer"]["launches"] = phase_lsdnn(dev)
    phase_device_task(dev)
    done("K4, LSDNN, DEVICE task")
    report["cond_graph"] = phase_condgraph(dev, smi)
    done("condgraph and the quick bench pass")
    ecounts = phase_examples(dev, smi)
    report["lsdnn_layer"]["launches"] += ecounts["lsdnn_layer"]
    done("examples")
    report["cond_graph"]["launches"] += phase_nested(dev)
    done("nested (a DeviceFlow holding a compiled CondGraph)")
    tcounts = phase_mesh(dev, smi)
    done("mesh (2 gloo ranks on the card)")
    tmesh = phase_train_mesh(dev, smi)
    mcounts_tm = {k: tmesh["falcon-mamba"]["launches"][k]
                  + tmesh["falcon-mamba-tp"]["launches"][k]
                  for k in ("mamba_scan", "mamba_scan_bwd")}
    mcounts_tm["mamba_scan"] += tmesh["serve_tp"]["launches"]["mamba_scan"]
    scounts_tm = tmesh["serve_tp"]["launches"]["flash_attention"]
    done("train_mesh (sharded training, 2 gloo ranks on the card)")
    dcounts_tm = phase_mesh_durable(dev, smi)
    done("mesh_durable (journal, snapshot, restore, isolation, per-call and "
         "crash_at under 2 gloo ranks)")
    phase_dryrun(train, tmesh, smi)
    done("dryrun (the meta-device dry run against the train phases)")
    report["paged_attention"]["launches"] = counts["paged_attention"] \
        + acounts["paged_attention"] + pcounts["paged_attention"] \
        + scounts["paged_attention"] + dcounts["paged_attention"] \
        + ccounts["paged_attention"] + qcounts["paged_attention"] \
        + report["cond_graph"]["k1_sweep"] + ecounts["paged_attention"] \
        + tcounts["paged_attention"] + dcounts_tm["paged_attention"]
    report["flash_attention"]["launches"] = counts["flash_attention"] \
        + acounts["flash_attention"] + pcounts["flash_attention"] \
        + scounts["flash_attention"] + dcounts["flash_attention"] \
        + ccounts["flash_attention"] + zcounts["flash_attention"] \
        + zpre["flash_attention"] + qcounts["flash_attention"] \
        + sum(c["flash_attention"] for c in train_counts) \
        + ecounts["flash_attention"] + tcounts["flash_attention"] \
        + dcounts_tm["flash_attention"] + scounts_tm
    report["mamba_scan"]["launches"] = mcounts["mamba_scan"] \
        + mpre["mamba_scan"] + sum(c["mamba_scan"] for c in train_counts) \
        + mcounts_tm["mamba_scan"]
    report["mamba_scan_bwd"]["launches"] = sum(c["mamba_scan_bwd"]
                                               for c in train_counts) \
        + mcounts_tm["mamba_scan_bwd"]
    if not report["mamba_scan_bwd"]["launches"]:
        raise SystemExit("the training phases launched no K3 backward")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{k: report[n][k] for k in keys}
               for n in ("paged_attention", "flash_attention", "mamba_scan",
                         "mamba_scan_bwd", "lsdnn_layer", "cond_graph")]
    if "jax" in sys.modules:
        raise SystemExit("jax was imported")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
