#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases build parity

Phases, each printing one JSON line (any failure exits nonzero):

  1 build     compile the CUDA kernels from src/repro_torch/kernels/csrc
              (nvcc, sm_90a) and load them; print the card's name and
              power limit as nvidia-smi reports them.
  2 contracts  the port's analysis gate, python -m repro_torch.analysis:
              the contracts pass, each DEFAULT_WORKLOADS entry's launch
              plan against the launch the wrappers make (KernelCall) and
              against what the C entry points report they would launch
              (mm_single_pass_config / mm_two_pass_config: blocks,
              threads, dynamic shared memory, the raw blocks an SM
              holds); the launch pass on the card (MM kernels counted by
              torch.profiler, the steady calls under
              torch.cuda.set_sync_debug_mode("error"), bf16 streams, the
              donation rule on the tree program (LoweredTree.donated and
              the leaves a call releases), one replay of each audited
              scenario's captured trajectory making num_steps x layouts
              launches, the service's captures).  Each workload's KernelCall is printed
              beside its C query; any finding not in
              ANALYSIS_BASELINE_TORCH.json fails the phase.  When the
              kernels line is printed, every (variant, K, M, N) the main
              paths launched gets the same comparison.
  3 parity    every kernel against its plain PyTorch version on the card,
              f32 and bf16 (f32: max |d| <= 1e-5 * max(1, |x|_inf), since
              sums run in another order; bf16: within 1 ulp).  Every
              single-pass variant (regs, warp, smem), forced through the
              launch plan, meets every edge: K at each template bound
              (1, 2, 5, 8, 9, 16, 17, 32, 33, 64, as far as the variant
              holds), N = 1, 5, 32, narrow, ragged and wide M, weighted
              and unweighted, tie-heavy columns (multiples of 0.5 under
              uniform weights, so crossings fall exactly on 1/2) and
              all-equal columns (the MAD floor).  The two-pass kernel
              meets the first slice's cases; the cohort's (512, 256, 1);
              (K, N) = (200, 200), (256, 256) and (512, 512), weighted, at
              M of 1,031-4,099; (4096, 8); K = 8192 at N = 1 (16 K
              blocks); K = 1100 at block_k 64 (18 blocks); K = 2048 at
              block_k 32 (64 blocks: the combine in shared memory); a
              last block of one row; a massless middle K block; ties,
              the MAD floor and ragged M; blocks of 8, 4, 2 and 1
              columns.  One summary line per kernel, variant and dtype,
              with its first failing cases.  The finiteness check
              (ops.any_nonfinite, csrc/finite.cu) against
              torch.isfinite(x).all() and its plain version: lengths
              around the vector width at storage offsets 0-3, NaN, +inf
              and -inf first, middle and last, f32, bf16 and the dtypes
              that take torch.isfinite; a 3.0 GB f32 payload, one layer's
              share and a bf16 tensor of more than 2^31 bytes, each
              timed beside its bytes over 3.35 TB/s (one more line).
              The service's norms after a commit (ops.residual_norms,
              csrc/residual.cu) against their plain version and a float64
              sum of the same f32 differences (within 2 ulp): 1 to 513
              rows at lengths 0 to 2^20 + 3, rows and centre at storage
              offsets 0-3, a Byzantine row (+1000), the same bits on a
              repeat; then 9 rows of 751,894,528 (serve-k8's 8 payloads
              and the model) and 129 of 15,730,944 (cohort128's), each
              timed beside its bytes over 3.35 TB/s and the eager
              vector_norm(row - center) loop it replaced (one more line).
  4 paper     repro_torch.scenarios.run on the paper's C3 spec (diffusion,
              K=32 fully connected, d=10, 1 attacker at delta=1000, 500
              steps) on the kernel backend: steady MSD < 1e-2; the mean
              aggregator as the breakdown contrast; the Robust-FedAvg MM
              setting of examples/federated.py (300 rounds); the
              stacked sharded lowering (K = 32, 6 attackers, 300 steps).
              The single-pass kernel must launch.  The three specs
              each run as captured_run does: runner.loop on the spec's
              lowering, state and seed, then a miss (trace_spec: a warm-up
              step and the capture of the whole trajectory as one CUDA
              graph, then one replay) and a hit (one replay) of
              scenarios.run; both histories bit-equal to the loop's, the
              hit's compile_s 0.0 and its launch counts the loop's, the
              miss's the loop's plus the warm-up step's; compile_s,
              wall_clock_s of the miss and the hit, the eager loop's
              seconds and the hit's device busy share printed.
  5 cohort    the large_cohort family's federated smoke spec (1024 clients
              at participation 0.5: a 512-agent aggregation), captured as
              the paper phase's specs, with the same checks.  The
              two-pass kernel must launch and the MSD stay finite.
  6 width     K=8 agents' updates shaped like Qwen3-0.6B's parameter tree
              (14 leaves, 751,894,528 coordinates each), made on the card,
              one agent shifted by 1000, through AggregationEngine
              .aggregate_tree: one launch, checked against the plain
              version over every column, timed with CUDA events.  Then
              (_width_compiled) engine.lower_tree(tree).compile(): a
              CUDA graph of kernel->split whose one call (stage +
              replay) launches once and gives aggregate_tree's estimate
              bit for bit; AggregationEngine(donate_leaves=True)'s
              aggregate_tree and tree program give it too and leave every
              leaf at 0 bytes; max_memory_allocated of the plain and the
              donated aggregate_tree from the same start, the donated at
              least 2.9 GB lower (the estimate's 3.01 GB).
  7 batch     one aggregate_batched launch at (K, M, N) = (32, 2^20, 32),
              the diffusion case, beside its plain version; then the
              same over 256 fully connected agents, (256, 2^16, 256),
              weighted, which takes the two-pass kernel.
  8 cohort_width  the large cohort aggregated over the parameters of one
              Qwen3-0.6B decoder layer: K = 512 clients (the last 64
              shifted by 1000), M = 15,730,944, f32, made on the card
              from a seed (32.2 GB), through AggregationEngine.aggregate:
              one two-pass launch, checked against the plain version
              over every column, timed as the other entries.
  9 autotune  tuning.autotune with REPRO_TORCH_TUNING_CACHE set to a file
              of a temporary directory, at (8, 751,894,528, 1) (Qwen3-0.6B's
              tree, 24.1 GB of x), (128, 15,730,944, 1) (serve_cohort's
              geometry) and (32, 10, 32) (the paper's diffusion step):
              every candidate's (block_m, block_k, path, variant) and ms,
              the winner, the heuristic's ms.  Gates: (a) a fresh process
              with the same environment reads the file and get_choice
              returns each winner; (b) AggregationEngine(autotune=True)
              .aggregate_tree over K = 8 Qwen3-0.6B-shaped updates (agent 7
              +1000) and .aggregate at the cohort shape launch the winner's
              variant/path (the workload record, launches.COUNTS), bit-
              equal to the wrapper's launch of that plan; (c) each within
              the parity tolerance of the plain version of that plan over
              every column; (d) a second autotune without force times
              nothing.  Then the cache is emptied and the variable unset:
              no later phase launches another geometry than it checks.
 10 entry_points  the port's examples, in this process through their
              main (python -m repro_torch.examples.<name>): quickstart and
              federated as the reference sizes them (REF/MM steady MSD <
              1e-2, the attacked mean broke down); scenario_sweep --smoke
              and --family large_cohort --smoke, --json into a temporary
              directory (every row finite, a launch audit on every kernel
              row, the single-pass kernel launched by the preset and the
              two-pass kernel by the 512-agent cohort); serve_agg --backend
              pallas, clean and mixed (exit 0); serve_lm for qwen3-0.6b and
              rwkv6-1.6b (smoke configs; "OK"); train_robust_lm --steps
              ENTRY_TRAIN_STEPS, three launch.train processes of 8 agents
              on the kernel (REF attacked finite, its last loss below mean
              attacked's).  Each distinct (variant, K, M, N) an example
              launched gets a kernels-line entry.

 11 serve     the streaming service (repro_torch.serve) through its
              replay harness, through repro_torch.benchmarks.serve_bench
              .run: the clean, stragglers, network and mixed
              (2 tenants sharing one cache) chaos profiles, 16 agents a
              tenant, dim 8, k_min 8, deadline 1 s, 30 rounds, seed 0,
              on the kernel backend.  Each profile must stay in its
              spec's band, complete every round, admit nothing twice
              and recover from every injected fault mode; each cohort
              geometry is captured once across tenants; launch_failed
              counts injected faults only.  Then a mixed replay with a
              crash at 0.5 (no duplicate admission) and two runs of one
              mixed replay, whose journals must be identical bytes.
 12 serve_width  the service at Qwen3-0.6B's full width (M =
              751,894,528, every layer): 8 agents' payloads made on the
              card, agent 7 shifted by 1000, k_min 8, three full
              cohorts.  One capture, three graph replays; agent 7 an
              outlier each time; the first commit bit-equal to an eager
              AggregationEngine.aggregate of the same cohort and within
              the parity tolerance of the plain version over every
              column.  Per commit: submit-to-commit time and the device
              times of staging, replay, outlier check and clip.  Every
              finiteness check on the kernel (launches.COUNTS'
              finite_scan): the initial model's, then one a submit and
              one a commit; one residual-norm launch a commit (its
              residual).
 13 serve_cohort  the service at k_min = 128 over one Qwen3-0.6B decoder
              layer (M = 15,730,944), the last 16 agents shifted by
              1000, two commits: the two-pass kernel in one 128-row K
              block, held to its plain version; the finiteness checks
              and residual-norm launches counted as in serve_width.
 14 lm_train  the LM substrate: full-size Qwen3-0.6B (28 layers, d_model
              1024, vocab 151,936 padded to 152,064, 751,894,528 f32
              parameters in 14 leaves, bf16 activations) randomly
              initialised on the card, trained 2 steps by the Mode A step
              launch.train builds: K = 8 agents of one 1024-token
              sequence each, agent 7 additive at +1000, rs_mm on the
              kernels, Adam with clip 1.0, the consensus metric.  Per
              step: host ms, the device times of its phases, loss,
              grad_norm and launches by variant (14 a step: 11 regs,
              3 warp) and by (K, M, N), which must be each leaf's shape
              once.  The host's CPU model, cores and load as /proc
              reports them; one agent's forward and backward with the
              host's operators traced: its host time by operator.  Gates:
              in step 1 every
              leaf's estimate is within 1e-5 x max(1, |estimate|_inf) and
              within 1e-5 x |estimate|_inf of the plain version on the
              same stack (each leaf's RMS |estimate| printed beside), and
              within 1 of the benign agents' mean over
              all 751,894,528 coordinates; loss and grad_norm finite, the
              first loss within 1.5 of ln(151,936).
 15 lm_serve  make_prefill_step and make_decode_step at the same size:
              batch 4, a 512-token prompt prefilled (timed), then fed
              through the decode step into the bf16 KV cache, then 32
              greedy tokens (ms per token).  Gate: the decode logits of
              the first 16 positions, and of the last prompt position
              against the prefill's, within 2^-4 x max(1, |logits|_inf)
              of the full-sequence forward's.
 16 ssm_train   lm_train's step and gates on full-size RWKV6-1.6B (24
              layers, d_model 2048, d_ff 7168, vocab 65,536;
              1,583,943,680 f32 parameters in 26 leaves): K = 4 agents of
              one 1024-token sequence (16 chunks of 64), agent 3 at
              +1000.  Besides lm_train's gates: the benign-mean gate's
              all-agent mean moves by at least 0.9 x 1000 / K, and every
              agent's gradient stack is finite in every leaf every step.
              Each leaf launched once a step, on the variant its launch
              plan picks (the wrappers' counts by shape).
 17 ssm_serve   lm_serve on RWKV6-1.6B, but 64 prompt tokens through the
              decode step from a zero state (16 held to the forward),
              then 32 greedy tokens.  The same weights also run with f32
              activations: their decode is held to their forward within
              1e-3 x max(1, |logits|_inf), and the bf16 decode's
              tolerance is at least twice the bf16 forward's distance
              from the f32 one (random-init RWKV6 at full width
              amplifies bf16 rounding; see LM_SERVE_TOL).
 18 hybrid_train  the same on Zamba2-2.7B at full width cut to 12 layers
              (2 groups of 6 Mamba2 layers, the shared attention block
              applied twice; 747,364,160 parameters in 21 leaves), K = 8:
              full depth with K >= 3 would not fit the card.
 19 hybrid_serve  ssm_serve's run on full-size Zamba2-2.7B (54 layers).
 20 audio_train  the same on full-size SeamlessM4T-large-v2 (24 encoder +
              24 decoder layers; 1,632,233,472 parameters in 25 leaves),
              K = 4, each agent's batch with 1024 stub frame embeddings.
 21 audio_serve  ssm_serve's run on it, the prompt's frames through the
              encoder and the cross cache projected by hand from the
              encoder output (no prefill fills it, as in the reference).
 22 sharded   the robust collectives (repro_torch.core.sharded) over 4
              agent processes sharing the card over gloo
              (launch.mesh.run_ranks, a 2 x 2 (pod, data) mesh): each
              collective checked and timed on CUDA tensors first (the
              transport printed); each rank's own update shaped like
              Qwen3-0.6B's tree (rank 3 at +1000) through
              robust_all_reduce_tree with rs_mm on the kernel, then
              mean.  Gates: every rank's local (4, M/4) estimate within
              1e-5 x max(1, |estimate|_inf) of the kernel's plain version
              on the same block; the results bit-identical across ranks
              (checksums); over one decoder layer rs_mm within that
              tolerance of gather_mm, and bit-equal where both launch the
              same variant; hier_mm equal to its pods' mean.  Per
              collective: host ms, the kernels' CUDA-event ms, the bytes
              each rank sent.
 23 fsdp_train  Mode B (launch.steps.make_train_step_fsdp) on full-size
              Qwen3-0.6B over the 4 agent processes, each one 1024-token
              sequence, rank 3 additive at +1000, rs_mm on the kernel,
              remat.  Mode A's SGD step (lr 1, no clip) runs first here
              on the same parameters and batches; the ranks' first step
              is the same SGD step, whose update p0 - p1 is held to Mode
              A's per leaf (all but max(2, 1%) of the coordinates within
              1e-6 + 1e-5 |want|, every one within 2^-8 of the leaf's
              largest |want|: a bf16 cotangent may round the other way
              where sums run in another order) and to the benign mean
              (within 1, while the all-agent mean moves >= 0.9 x 250);
              then 3 Adam steps with clip 1.0.  Every loss finite, step
              1 within 1.5 of ln V; launches a step 28 x 11 hooked + 3.
              The replicated leaves' drift across ranks after the Adam
              steps is printed (the reference clips each rank's local
              tree by its own norm).
 24 fsdp_serve  make_prefill_step / make_decode_step with fsdp=True on
              the same model sharded over the 4 processes, one row each:
              a 512-token prefill (timed) and decode logits teacher-
              forced on Mode A's greedy tokens (FSDP_SERVE_CHECKED
              positions), within 2^-4 x max(1, |logits|_inf) of Mode A's
              unsharded steps; then FSDP_SERVE_TOKENS (8) greedy tokens
              (ms per token; a token takes ~2 s over gloo).
 25 dryrun    repro_torch.launch.dryrun on meta tensors: the pairs of the
              arch x shape matrix in DRYRUN_PAIRS on 16 agent ranks (the
              others named on a line first), traced one after another
              by a spawned process that starts with DRYRUN_MATRIX_FROM
              (entry_points, whose times back no claim) and runs beside
              the phases from there on (printed as matrix_beside_phases;
              matrix_s is its wall time, matrix_wait_s this phase's
              wait for it), each pair's counts printed;
              then a full-size Qwen3-0.6B Mode A step (K = 8 agents of one
              1024-token sequence, as lm_train) run on the card and traced
              on meta: the MM launches by (variant, K, M, N) (14), the
              FlopCounterMode flops and the argument bytes (the caching
              allocator's requested bytes, and torch.cuda.memory_allocated
              against the meta bytes rounded to its 512-byte blocks)
              must be equal; and Mode B at
              fsdp_train's shape on a 4-rank group that moves nothing,
              whose bytes sent by kind must equal every rank's in every
              step of fsdp_train.  The predicted peak (arguments + saved
              for backward, and the live peak) beside the measured
              max_memory_allocated, not gated.  Each pair's record goes to
              experiments/dryrun_torch/ (DRYRUN_DIR) for the roofline.
 26 bench     the port's benchmarks (repro_torch.benchmarks), each as a
              user runs it, from the checkout's root: paper_fig1 at the
              paper's size (K = 32, d = 10, 1000 iterations, 33 settings,
              each run_diffusion a captured trajectory; C1, C2 and C3
              must PASS, C3's clean-efficiency clause on
              the median over seeds 0-3, every steady MSD finite); run.py
              --only agg,kernel,roofline (every row finite; kernel_bench's
              13 kernel rows each within 1e-5 x max(1, |x|_inf) of the
              plain version; agg_bench's substrate row trains full-size
              Qwen3-0.6B with K = 8 agents, 10 steps, its peak memory
              printed; a roofline row for each record the dryrun phase
              wrote); scenario_sweep --family large_cohort --json;
              serve_bench --json; bench_audit over the three JSON files in
              experiments/bench_torch/ (every audit ok).  Each (variant, K,
              M, N) a step launched gets a kernels-line entry (10 launches
              in its event pair).
 27 coarse_keys  the weighted group layout of 16 rows a lane, which sorts
              on 32-bit coarse keys that carry the row and sorts a warp's
              tile again on (key, row) pairs where its check fails, at
              K = 128 on the serve cohort's mix (112 N(0, 1) rows, 16
              copies of row 0 + 1000), on narrow data (1000 + N(0,
              1e-3)) and on clustered columns (rows at -1000 and 1000,
              the rest 1 + j ulp, j < 100), made on the card at one
              decoder layer's width: at M = 2^20 (a strided view, and a
              row table of its rows) the launch through the table equals
              the (x, ld) launch bit for bit and lies within the parity
              tolerance of the plain version; at both widths the share
              of warp-tiles that took the pairs (mm_two_pass_exact_tiles:
              a few percent on the mix, none on narrow data, all on the
              clustered columns) and, at the layer, the table launch's
              ms (20 back-to-back launches in one event pair).

The service's launches, the tree program's and the scenario runs' are
CUDA-graph replays: the kernel wrappers count the warm-up launch before
each capture but not the captured ones, whose keys the capture returns
(ops.capture_graph) and the program counts in launches.COUNTS on each
replay (ops.LaunchProgram, ops.TreeProgram, runner.ScenarioProgram); the serve entries of
the kernels line take their launches from the service's own count of
replays.  A serve entry's ``ms`` is one event pair around back-to-back
replays of the service's program, ``call_ms`` one replay at a time.

After the phases, one line with each phase's seconds and the total;
then one {"kernels": [...]} line, the nvidia-smi line, and the final
{"ok": true, "device": ...} line.  A kernel's ``ms`` is one CUDA-event
pair around 50 back-to-back launches (10 for the 256-agent batch and
the cohort layer), divided by their count; ``call_ms`` is the median of
three single launches, each inside its own event pair with the wrapper's
host work (the way the first slice timed it); ``profiler_ms`` is a
call's device time by torch.profiler: the sum over every kernel the call
runs of its device time per launch (``profiler_kernels`` gives each
kernel's name and share).  Each entry of the kernels line is one
main-path run (the paper and federated scenarios, the large cohort and
its layer-wide launch, the tree launch, the diffusion batches, the
autotuned engine's two launches, each example of entry_points and each
LM train phase: one entry per distinct (variant, K, M, N)) and its
launches are that run's own
count: every count is set to 0 just before the run and read just after;
launches made to time a kernel or compare it with its plain version are
not counted.  bound_ms is the larger of the bytes the function must move
over 3.35 TB/s and its f32 operations (mm_ops) over 67 TFLOP/s (H100 SXM
data sheet).  No single PyTorch call computes an MM estimate, so
library_ms is null.  The finite_scan entries (serve_width's and
serve_cohort's: the service's finiteness checks, ops.any_nonfinite) take
their launches from the same main-path runs, bound_ms from the payload's
bytes alone, library_ms from torch.isfinite(x).all(), the check they
replaced, and aminmax_ms from torch.aminmax(x), one library read of x;
their parity_max_abs_err counts the parity phase's finiteness cases
that disagreed with torch.isfinite.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PHASES = ("build", "contracts", "parity", "paper", "cohort", "width",
          "batch", "cohort_width", "autotune", "entry_points", "serve",
          "serve_width", "serve_cohort", "lm_train", "lm_serve", "ssm_train",
          "ssm_serve", "hybrid_train", "hybrid_serve", "audio_train",
          "audio_serve", "sharded", "fsdp_train", "fsdp_serve", "dryrun",
          "bench", "coarse_keys")
# torch.profiler windows traced for one kernels-line entry before its
# device time is reported as missing (Smoke.profiler_ms)
PROFILER_WINDOWS = 12

# Qwen3-0.6B (configs/qwen3_0p6b.py) parameter tree: leaf shapes
QWEN3_0P6B_SHAPES = {
    "blocks": {
        "attn": {"k_norm": (28, 128), "q_norm": (28, 128),
                 "wk": (28, 1024, 1024), "wo": (28, 2048, 1024),
                 "wq": (28, 1024, 2048), "wv": (28, 1024, 1024)},
        "ln1": (28, 1024), "ln2": (28, 1024),
        "mlp": {"w_down": (28, 3072, 1024), "w_gate": (28, 1024, 3072),
                "w_up": (28, 1024, 3072)},
    },
    "embed": (152064, 1024),
    "head": (1024, 152064),
    "ln_f": (1024,),
}
WIDTH_AGENTS = 8

# single-pass parity edges: K at each template bound of the variants, and
# (M, N, weighted, kind) so that every variant meets narrow, ragged and
# wide M, N = 1, 5 and 32, both medians, ties and the MAD floor
PARITY_K = (1, 2, 5, 8, 9, 16, 17, 32, 33, 64)
PARITY_KINDS = ("contaminated", "ties", "all_equal", "massless",
                "exact_half")
PARITY_EDGES = ((10, 1, False, "contaminated"), (10, 5, True, "ties"),
                (4099, 32, True, "contaminated"), (4099, 1, True, "all_equal"),
                (65536, 1, False, "all_equal"), (65536, 5, True, "ties"),
                (65539, 1, True, "contaminated"))
# finiteness-check parity (ops.any_nonfinite): lengths around the 16-byte
# vector of f32 (4) and bf16 (8) elements, views at storage offsets 0-3,
# NaN, +inf and -inf first, in the middle and last; the service's widths
# (one 3.0 GB f32 payload, one layer's share) and a bf16 tensor of more
# than 2^31 bytes
FINITE_LENGTHS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 16, 17, 33, 1000, 4099,
                  (1 << 20) + 3)
FINITE_OFFSETS = (0, 1, 2, 3)
FINITE_SPECIALS = (float("nan"), float("inf"), float("-inf"))
FINITE_WIDE = (("f32", 751_894_528), ("f32", 15_730_944),
               ("bf16", (1 << 30) + 3))
# residual-norm parity (ops.residual_norms): row counts around the
# kernel's 16 rows a pass, lengths around its 16-byte vector; then the
# services' commits, (rows, M): serve-k8's 8 payloads and the model, and
# cohort128's 128 and the model
RESIDUAL_ROWS = (1, 2, 9, 16, 17, 129, 513)
RESIDUAL_LENGTHS = (0, 1, 5, 4099, (1 << 20) + 3)
RESIDUAL_WIDE = ((9, 751_894_528), (129, 15_730_944))
# two-pass parity cases (K, M, N, weighted, block_k, kind): the first
# slice's; the cohort's; the (K, N) the first kernel could not fit; 16,
# 18 and 64 K blocks; a last block of one row; a massless middle block;
# ties, the MAD floor and ragged M; blocks of 8, 4, 2 and 1 columns
TWO_PASS_CASES = (
    (128, 2049, 1, True, None, "contaminated"),
    (300, 513, 3, True, None, "contaminated"),
    (1024, 4096, 1, False, 512, "contaminated"),
    (96, 777, 2, True, 32, "contaminated"),
    (2048, 1024, 1, True, 512, "contaminated"),
    (512, 256, 1, False, None, "contaminated"),
    (200, 1031, 200, True, None, "contaminated"),
    (256, 4099, 256, True, None, "contaminated"),
    (256, 1031, 256, True, None, "ties"),
    (512, 1031, 512, True, None, "contaminated"),
    (4096, 4099, 8, True, None, "contaminated"),
    (4096, 4099, 1, False, None, "all_equal"),
    (8192, 1031, 1, True, None, "contaminated"),
    (8192, 1031, 1, False, None, "ties"),
    (1100, 4099, 1, True, 64, "contaminated"),
    (1100, 4099, 1, False, 64, "all_equal"),
    (2048, 1031, 1, True, 32, "contaminated"),
    (2048, 1031, 1, False, 32, "ties"),
    (513, 4099, 8, True, None, "ties"),
    (1024, 4099, 2, True, 256, "massless"),
    (512, 300, 2, True, None, "all_equal"),
    (70, 4099, 1, True, 32, "ties"),
    (65, 4099, 1, False, None, "all_equal"),
    (300, 65539, 1, True, None, "all_equal"),
    # one K block, the group layout: 65, 100 and 301 agents over 2^16
    # columns at N = 1 and 3, ties and massless (zero-weight) rows
    (65, 65536, 1, True, None, "contaminated"),
    (65, 65536, 3, True, None, "ties"),
    (100, 65536, 1, True, None, "massless"),
    (100, 65536, 3, True, None, "contaminated"),
    (301, 65536, 1, True, None, "ties"),
    (301, 65536, 3, True, None, "massless"),
    (100, 65536, 1, False, None, "contaminated"),
    (301, 65537, 1, False, None, "ties"),
    (40, 4099, 2, True, 64, "ties"),
    (16, 4099, 1, True, 16, "contaminated"),
    (128, 65536, 1, True, None, "exact_half"),
    (301, 65536, 3, True, None, "exact_half"),
)
# full-width two-pass parity (K, M, N, dtype, weighted): the service's
# launch and the large-cohort layer's weighted twin over one decoder
# layer, the diffusion batch, and bf16 at 2^20
TWO_PASS_WIDE = ((128, 15_730_944, 1, "float32", True),
                 (512, 15_730_944, 1, "float32", True),
                 (256, 65_536, 256, "float32", True),
                 (128, 1 << 20, 1, "bfloat16", True))
# the large cohort aggregated layer by layer: 512 participating clients
# (examples/scenario_sweep.py large_cohort, 1024 at participation 0.5)
# over the parameters of one Qwen3-0.6B decoder layer, the last 64
# (12.5%) shifted by 1000
COHORT_K, COHORT_BAD = 512, 64
# the streaming service's cohorts: benchmarks/serve_bench.py's rows (the
# mixed profile with two tenants), and the 128-client cohort that the
# service aggregates over one decoder layer, the last 16 shifted by 1000
SERVE_PROFILES = (("clean", 1), ("stragglers", 1), ("network", 1),
                  ("mixed", 2))
SERVE_ROUNDS = 30
SERVE_COHORT_K, SERVE_COHORT_BAD = 128, 16
# the LM substrate: each train phase is launch.train's arguments for K
# agents of one 1024-token sequence each (the attention families' two
# q_chunk = 512 chunks; RWKV6's 16 chunks of 64, Zamba2's 8 of 128), the
# last agent additive at +1000, 2 steps (so that the whole run, the
# collectives' phases included, stays near half its time limit), and
# what its model must be:
# its full config (the hybrid cut to 12 layers), its parameter and leaf
# counts.  Qwen3-0.6B's phase also fixes its launches by variant and
# traces one agent's host operators
QWEN3_0P6B_PARAMS = 751_894_528
# the entry_points phase's train_robust_lm: steps of each of its three
# launch.train processes (the example's default is 300)
ENTRY_TRAIN_STEPS = 10


# the dry run's pairs traced on the card's host (of 10 archs x 4 shapes):
# every arch at both decode shapes and Qwen3-0.6B at every shape.  A
# train_4k or prefill_32k trace of the other archs takes 20 s to an hour
# of one core here (PERF.md section 6, the dry-run table, by
# python -m repro_torch.launch.dryrun on the CPU), past the run's limit
DRYRUN_PAIRS = tuple(
    [(a, s) for a in ("seamless_m4t_large_v2", "zamba2_2p7b",
                      "qwen1p5_110b", "rwkv6_1p6b", "qwen3_0p6b",
                      "qwen3_32b", "qwen3_moe_235b_a22b", "dbrx_132b",
                      "stablelm_3b", "llava_next_34b")
     for s in ("decode_32k", "long_500k")]
    + [("qwen3_0p6b", "train_4k"), ("qwen3_0p6b", "prefill_32k")])
# where the dryrun phase writes its records (the bench phase's roofline
# reads them) and the bench phase its outputs
DRYRUN_DIR = HERE / "experiments" / "dryrun_torch"
# the matrix's pairs are traced on meta tensors by one process of their
# own, started with DRYRUN_MATRIX_FROM: host work that overlaps the
# phases from there to dryrun instead of adding to the run.  It starts
# after the paper, cohort, width and autotune phases, whose host and
# device times it would disturb, and beside entry_points, whose times
# back no claim
DRYRUN_MATRIX_FROM = "entry_points"
DRYRUN_MATRIX_TIMEOUT_S = 900.0
BENCH_DIR = HERE / "experiments" / "bench_torch"
# the bench phase's kernels-line entries: launches in one event pair
BENCH_TIMED_LAUNCHES = 10
DRYRUN_LEFT_OUT_WHY = ("the other archs' train_4k and prefill_32k traces "
                       "take 20 s to an hour of one core (PERF.md, the "
                       "dry-run table)")


def _train_args(arch: str, agents: int, *extra: str) -> tuple:
    return ("--arch", arch, "--full-config", "--agents", str(agents),
            "--use-kernel", "--malicious", "1", "--attack", "additive",
            "--delta", "1000", "--aggregation", "rs_mm", "--steps", "2",
            "--batch", str(agents), "--seq", "1024") + extra


LM_TRAIN_ARGS = _train_args("qwen3-0.6b", 8)
LM_TRAIN_RUNS = {
    "lm_train": dict(label="Qwen3-0.6B", args=LM_TRAIN_ARGS,
                     params=QWEN3_0P6B_PARAMS, leaves=14,
                     variants={"regs": 11, "warp": 3}, host_profile=True),
    "ssm_train": dict(label="RWKV6-1.6B", args=_train_args("rwkv6-1.6b", 4),
                      params=1_583_943_680, leaves=26),
    # 54 layers with K >= 3 would need over 90 GB: 12 (2 groups of 6,
    # the shared block applied twice) at full width
    "hybrid_train": dict(label="Zamba2-2.7B (12 layers)",
                         args=_train_args("zamba2-2.7b", 8, "--layers", "12"),
                         params=747_364_160, leaves=21),
    "audio_train": dict(label="SeamlessM4T-large-v2",
                        args=_train_args("seamless-m4t-large-v2", 4),
                        params=1_632_233_472, leaves=25),
}
# the serve phases: each full config at batch 4, a 512-token prompt
# prefilled (timed), ``teacher`` prompt tokens fed through the decode
# step from a zero state (Qwen3: the whole prompt, its last position also
# held to the prefill's), then 32 greedy tokens
LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_TOKENS = 4, 512, 32
LM_SERVE_CHECKED = 16      # decode positions held to the forward's logits
LM_SERVE_RUNS = {
    "lm_serve": dict(arch="qwen3-0.6b", teacher=LM_SERVE_PROMPT,
                     params=QWEN3_0P6B_PARAMS, leaves=14),
    "ssm_serve": dict(arch="rwkv6-1.6b", teacher=64, params=1_583_943_680,
                      leaves=26, f32_check=True),
    "hybrid_serve": dict(arch="zamba2-2.7b", teacher=64,
                         params=2_422_670_240, leaves=21, f32_check=True),
    "audio_serve": dict(arch="seamless-m4t-large-v2", teacher=64,
                        params=1_632_233_472, leaves=25, f32_check=True),
}
# bf16 decode against the full-sequence forward: the two paths round
# their products at different shapes through every layer (and the
# recurrent families sum their chunks in another order), so the logits
# may differ by a few bf16 steps; 2^-4 of the largest logit is 16 ulps
# at its magnitude.  Rehearsed on the CPU at each family's full depth
# and a narrow width (tests/test_torch_lm_families.py).  At full width
# RWKV6's random-init bf16 forward is itself far from its f32 forward (a
# 1-ulp difference early grows through the layers), so the phases with
# ``f32_check`` also run the
# f32 activations: the bf16 decode is held to max(2^-4 x |logits|_inf,
# twice the bf16 forward's distance from the f32 one) -- each bf16 path
# lies about that far from the f32 logits -- and the f32 decode to the
# f32 forward within 1e-3 x max(1, |logits|_inf) (sums in another order)
LM_SERVE_TOL = 2.0 ** -4
LM_SERVE_F32_TOL = 1e-3
# the collectives and Mode B: K agent processes share the card over gloo
# (NCCL takes no two ranks on one GPU), a 2 x 2 (pod, data) mesh for
# hier_mm; the last agent adds +1000; every rank's collectives time out
# after DIST_TIMEOUT_S
DIST_K, DIST_PODS, DIST_DELTA = 4, 2, 1000.0
DIST_TIMEOUT_S = 600.0
# fsdp_serve holds this many decode positions to Mode A's logits: every
# decode token gathers every layer again (0.66 GB sent a rank, ~2 s over
# gloo on one card), so fewer than lm_serve's LM_SERVE_CHECKED
FSDP_SERVE_CHECKED = 4
# greedy tokens fsdp_serve times: a token takes ~2 s over gloo, so fewer
# than the unsharded serve phases' LM_SERVE_TOKENS
FSDP_SERVE_TOKENS = 8
# Mode B's step-1 update against Mode A's on the same parameters and
# batches: the bf16 cotangent of a gathered leaf may round to the other
# side of a bf16 step where the two paths sum in another order, so all
# but max(2, 1%) of a leaf's coordinates within 1e-6 + 1e-5 |want|, and
# every one within 2^-8 of the leaf's largest |want| (tests/
# test_torch_fsdp.py holds the port to the reference by the same rule)
FSDP_TRAIN_STEPS = 3


def layer_width() -> int:
    """Parameters of one Qwen3-0.6B decoder layer: each blocks.* leaf of
    the table divided by its 28 layers."""
    shapes, _ = qwen3_shapes()
    return sum(math.prod(sh[1:]) for sh in shapes if len(sh) > 1
               and sh[0] == 28)


def qwen3_shapes():
    """(leaf shapes in tree order, tree definition) of the table."""
    from repro_torch import pytree
    return pytree.flatten(QWEN3_0P6B_SHAPES,
                          is_leaf=lambda t: isinstance(t, tuple))


def autotune_shapes() -> tuple:
    """(label, K, M, N) the autotune phase sweeps: the full width of
    Qwen3-0.6B's tree, the service's 128-client cohort over one decoder
    layer, and the paper's diffusion step."""
    return (("Qwen3-0.6B tree", WIDTH_AGENTS, QWEN3_0P6B_PARAMS, 1),
            ("serve_cohort", SERVE_COHORT_K, layer_width(), 1),
            ("paper diffusion step", 32, 10, 32))


def host_info() -> dict:
    """The host a step ran on: its CPU model, the cores this process may
    use, and the load average as the phase ends."""
    import os
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), None)
    except OSError:
        pass
    return {"cpu": model, "cores": len(os.sched_getaffinity(0)),
            "loadavg": os.getloadavg()}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def mm_ops(k: int, m: int, n: int, weighted: bool, num_iters: int = 10,
           sort_rows: int = 0) -> int:
    """f32 operations the MM estimate needs
    (``repro_torch.kernels.mm_aggregate.modeled_ops``)."""
    from repro_torch.kernels.mm_aggregate import modeled_ops
    return modeled_ops(k, m, n, weighted, num_iters, sort_rows)


def ptxas_summary(log: str) -> list:
    """Per compiled kernel of ``nvcc -Xptxas -v`` output: its (mangled)
    name, registers, stack frame and spill bytes."""
    rows, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"fn": ln.split("'")[1]}
            rows.append(cur)
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.split()
            cur["registers"] = int(words[words.index("Used") + 1])
    return rows


def bound(bytes_moved: int, ops: int) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Smoke:
    def __init__(self, torch, args):
        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda")
        self.kernels = {}          # entry name -> kernels-line dict
        # the worst parity error of each kernel; finite_scan's is its
        # parity cases whose verdict disagreed with torch.isfinite
        self.parity_err = {"single_pass": 0.0, "two_pass": 0.0,
                           "finite_scan": 0, "residual": 0}
        self.busy_kernels = None   # device_busy_share's last kernel count
        self.busy_top = None       # and its top kernels by device time
        self.by_shape = {}         # main_path's launches by (kernel, K, M, N)
        self.finite_launches = 0   # and its finiteness checks on the card
        self.residual_launches = 0  # and its residual-norm launches
        # every (variant or "two_pass", K, M, N) a main path launched: the
        # contracts check holds each one's KernelCall to the C query
        self.kernel_shapes = set()
        self.contracts_ran = False
        self.fsdp_traffic = None   # fsdp_train's bytes sent by rank 0, a step
        self.dryrun_records = 0    # records the dryrun phase wrote (bench)
        self.dryrun_matrix = None  # the matrix's traces, in the background
        self.dryrun_beside: list = []  # the phases that ran beside them

    # -- helpers -----------------------------------------------------------

    def time_ms(self, fn, reps: int = 3, warmup: int = 1) -> tuple:
        """(median ms over reps, last result), one CUDA-event pair each."""
        torch = self.torch
        out = None
        for _ in range(warmup):
            out = fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), out

    def kernel_ms(self, fn, launches: int = 50) -> tuple:
        """(ms per launch, last result): one CUDA-event pair around
        ``launches`` back-to-back calls, after two warm-up calls."""
        torch = self.torch
        out = fn()
        out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / launches, out

    def profiler_ms(self, fn, launches: int = 10) -> tuple:
        """(device ms of one call of fn, {kernel name: device ms per
        launch}) from torch.profiler over ``launches`` calls: a call's
        time is the sum over every kernel it runs, whatever its name;
        (None, {}) where the profiler reports no device time.  After the
        LM phases' step-long windows a window often records the launches
        but none of the kernels (a third of the windows succeeded in one
        call on the card), so an empty window is traced again, up to
        PROFILER_WINDOWS times; the host's operators are traced too,
        which recorded the kernels where CUDA tracing alone did not."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        by_name: dict = {}
        for _attempt in range(PROFILER_WINDOWS):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(launches):
                    fn()
                torch.cuda.synchronize()
            # per recorded launch: the profiler may drop a window's first
            by_name = {e.key: e.self_device_time_total * 1e-3 / e.count
                       for e in prof.key_averages()
                       if e.count and getattr(e, "self_device_time_total", 0)}
            if by_name:
                break
        return (sum(by_name.values()) if by_name else None), by_name

    @staticmethod
    def _tally(counts):
        """The MM launches of a launch tally (a Counter of launches.COUNTS'
        keys): (by kernel path, single-pass by variant, by (variant or
        "two_pass", K, M, N))."""
        from repro_torch.kernels import mm_aggregate as mk
        by_shape = {key: n for key, n in counts.items()
                    if key[0] in mk.MM_KERNELS and n > 0}
        by_variant = {v: sum(n for key, n in by_shape.items() if key[0] == v)
                      for v in mk.MM_KERNELS}
        two_pass = by_variant.pop("two_pass")
        return ({"single_pass": sum(by_variant.values()),
                 "two_pass": two_pass}, by_variant, by_shape)

    def main_path(self, fn):
        """Run fn with the launch tally emptied; (result, its MM launches
        by kernel path, the single-pass launches by variant).  Its MM
        launches by (variant or "two_pass", K, M, N) are left in
        ``self.by_shape``, its finiteness checks launched on the card in
        ``self.finite_launches``, its residual-norm launches in
        ``self.residual_launches``."""
        from repro_torch.kernels import launches as tally
        tally.COUNTS.clear()
        result = fn()
        self.torch.cuda.synchronize()
        counts, by_variant, self.by_shape = self._tally(tally.COUNTS)
        self.finite_launches = tally.total("finite_scan")
        self.residual_launches = tally.total("residual")
        self.kernel_shapes.update(self.by_shape)
        return result, counts, by_variant

    def not_counted(self, fn):
        """Run fn (a comparison launch) without touching the counts."""
        from repro_torch.kernels import launches as tally
        with tally.uncounted():
            return fn()

    def measure(self, key, label, x, a, plan, counts, by_variant,
                weighted=True, launches=50, chunk=None):
        """Time a kernel (``ms``: ``launches`` back-to-back launches;
        ``call_ms``: one call at a time, as the first slice did;
        ``profiler_ms``: a call's device time) and its plain version on
        the same inputs (``chunk`` columns at a time), compare them, and
        record the kernels-line entry with the launches of the main-path
        run (``counts``, ``by_variant``) that gave the shape.  A
        single-pass entry's plan must name the variant that run
        launched."""
        from repro_torch.kernels import mm_aggregate as mk
        two = plan.path == "two_pass"
        if not two:
            assert by_variant[plan.variant] == counts["single_pass"] > 0, \
                (key, plan.variant, by_variant)
        run = mk.two_pass if two else mk.single_pass
        call = lambda: run(x, a, plan, weighted=weighted)
        call_ms, _ = self.not_counted(lambda: self.time_ms(call))
        ms, got = self.not_counted(lambda: self.kernel_ms(call, launches))
        prof, by_name = self.not_counted(lambda: self.profiler_ms(
            call, launches=3 if ms > 10 else 10))
        pms, err = self.plain_check(x, a, got, plan, weighted, chunk)
        assert err <= 1e-5 * max(1.0, float(x.abs().max())), (key, err)
        t, by = bound(plan.total_bytes,
                      mm_ops(x.shape[0], x.shape[1], plan.n_out, weighted,
                             sort_rows=plan.block_k if two else 0))
        name = "mm_two_pass" if two else "mm_single_pass"
        self.kernels[key] = dict(
            name=key, shape=label, variant=plan.variant or "two_pass",
            launches=counts["two_pass" if two else "single_pass"],
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces="src/repro/kernels/mm_aggregate.py:" +
                     ("306" if two else "243"),
            max_abs_err=err, ms=ms, call_ms=call_ms, profiler_ms=prof,
            profiler_kernels=by_name, plain_ms=pms, bound_ms=t, bound_by=by,
            library_ms=None, block_m=plan.block_m, block_k=plan.block_k,
            n_chunk=plan.n_chunk)
        return self.kernels[key]

    def plain_check(self, x, a, got, plan, weighted, chunk=None):
        """(ms of the plain version over every column, its max |d| from
        the kernel's ``got``), run ``chunk`` columns at a time (all at
        once for None) so its (K, N, M) planes fit the card."""
        from repro_torch.kernels import mm_aggregate as mk
        k, m = x.shape
        chunk = chunk or m
        plain_ms, err = 0.0, 0.0
        for lo in range(0, m, chunk):
            xc = x[:, lo:lo + chunk].contiguous()
            pc = mk.launch_plan(k, xc.shape[1], plan.n_out, path=plan.path,
                                block_k=plan.block_k, variant=plan.variant)
            xp, ap = mk._pad_inputs(xc, a, plan=pc)
            if plan.path == "two_pass":
                plain = lambda: mk.mm_two_pass_plain(
                    xp, ap, k=k, block_k=plan.block_k, weighted=weighted)
            else:
                plain = lambda: mk.mm_single_pass_plain(xp, ap, k=k,
                                                        weighted=weighted)
            t, want = self.time_ms(plain, reps=1, warmup=0)
            plain_ms += t
            err = max(err, float((got[:, lo:lo + chunk]
                                  - want[:, :xc.shape[1]]).abs().max()))
            del xc, xp, want
        return plain_ms, err

    def device_busy_share(self, fn, cpu: bool = True):
        """Share of fn's wall time the card spent in kernels, from
        torch.profiler (tracing the host's operators too unless ``cpu``
        is False); None where the profiler reports no device time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CUDA]
        if cpu:
            activities.insert(0, ProfilerActivity.CPU)
        try:
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        except Exception as exc:  # the share is reported, never required
            print(f"profiler unavailable: {exc!r}", file=sys.stderr)
            return None
        timed = [e for e in prof.key_averages()
                 if getattr(e, "self_device_time_total", 0.0)]
        busy_us = sum(e.self_device_time_total for e in timed)
        # kernels launched in the window, by the device-timed events, and
        # the eight that took the most device time (ms, launches)
        self.busy_kernels = sum(e.count for e in timed)
        self.busy_top = {e.key[:80]: (e.self_device_time_total * 1e-3, e.count)
                         for e in sorted(timed, key=lambda e:
                                         -e.self_device_time_total)[:8]}
        return (busy_us * 1e-6 / wall) if busy_us > 0 else None

    def host_profile(self, fn, top: int = 15) -> dict:
        """fn once under torch.profiler with the host's operators and the
        CUDA runtime calls traced: its wall ms (the tracing slows it), the
        seconds the profiler's summary took, the host's self time summed
        over every event, and the ``top`` events by self host time (ms,
        count)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        events = [e for e in prof.key_averages() if e.self_cpu_time_total]
        events.sort(key=lambda e: -e.self_cpu_time_total)
        return {"wall_ms": wall_ms,
                "summary_s": time.perf_counter() - t0,
                "host_self_ms": sum(e.self_cpu_time_total
                                    for e in events) * 1e-3,
                "top_host_ms": {e.key[:80]: (e.self_cpu_time_total * 1e-3,
                                             e.count)
                                for e in events[:top]}}

    # -- phases ------------------------------------------------------------

    def build(self):
        from repro_torch.kernels import build, mm_aggregate as mk
        t0 = time.perf_counter()
        libs = build.load_all()
        seconds = time.perf_counter() - t0
        # the launch plan's shared-memory model is what the kernels carve
        for variant, code in mk.SINGLE_PASS_VARIANTS.items():
            for k, n, bm in ((5, 1, 256), (32, 32, 128), (64, 1, 256),
                             (8, 4, 64)):
                got = libs["mm_single_pass"].mm_single_pass_smem_bytes(
                    code, k, n, bm)
                assert got == mk.variant_smem_bytes(variant, k, n, bm), \
                    (variant, k, n, bm, got)
        for k, nc, bk, bm in ((512, 1, 512, 8), (1024, 1, 512, 8),
                              (8192, 1, 512, 4), (256, 64, 256, 8),
                              (96, 2, 32, 4), (2048, 1, 32, 8),
                              (65, 1, 128, 1), (128, 1, 128, 64),
                              (512, 1, 512, 16), (256, 64, 256, 32),
                              (301, 3, 512, 16), (12, 2, 16, 256),
                              (40, 1, 64, 128)):
            for table in (False, True):  # a launch over a row table too
                got = libs["mm_two_pass"].mm_two_pass_smem_bytes(
                    k, nc, bk, bm, int(table))
                assert got == mk.two_pass_smem_bytes(k, nc, bk, bm,
                                                     table=table), \
                    (k, nc, bk, bm, table, got)
        ptxas = ptxas_summary(build.build_log())
        assert ptxas and not any(f.get("stack", 0) or f.get("spill_stores", 0)
                                 or f.get("spill_loads", 0) for f in ptxas), ptxas
        emit({"phase": "build", "seconds": seconds,
              "per_library_s": build.BUILD_SECONDS, "ptxas": ptxas,
              "gpu": self.torch.cuda.get_device_name(0)})
        print(nvidia_smi(), flush=True)

    def contracts(self):
        """The port's analysis gate on the card (python -m
        repro_torch.analysis: the contracts pass with the C entry points'
        queries, the launch pass with torch.profiler's counts and the
        sync check), then each DEFAULT_WORKLOADS entry's Python
        KernelCall beside the C query.  The kernels line's shapes get the
        same comparison when the line is printed (_query_kernel_shapes).
        Fails on any finding that is not baselined."""
        import os
        import shutil
        import tempfile
        from repro_torch.analysis import __main__ as gate
        from repro_torch.analysis import contracts as C
        from repro_torch.analysis import launch_audit
        from repro_torch.kernels import launches as tally
        tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
        try:
            path = os.path.join(tmp, "analysis.json")
            with tally.uncounted():
                rc = gate.main(["--root", str(HERE), "--json", path])
            with open(path) as f:
                report = json.load(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        assert rc == 0 and not report["unbaselined"] and \
            not report["stale_baseline_keys"], report
        assert launch_audit.unchecked() == []
        rows = [C.describe(*wl, on_card=True) for wl in C.DEFAULT_WORKLOADS]
        for row in rows:
            emit(dict(row, phase="contracts"))
        assert all(row["equal"] for row in rows), rows
        emit({"phase": "contracts", "gate_rc": rc,
              "timings_s": report["timings_s"],
              "baselined": len(report["baselined"]), "unbaselined": 0,
              "workloads": len(rows), "sms": rows[0]["c"]["sms"]})
        self.contracts_ran = True

    def _query_kernel_shapes(self) -> None:
        """Every (variant, K, M, N) the main paths launched: the Python
        KernelCall of its plan beside the C query (f32, weighted, as the
        kernels line times most of them)."""
        from repro_torch.analysis import contracts as C
        rows = []
        for variant, k, m, n in sorted(self.kernel_shapes):
            two = variant == "two_pass"
            row = C.describe(k, m, n, path="two_pass" if two else "single",
                             variant=None if two else variant, on_card=True)
            rows.append(row)
            emit(dict(row, phase="contracts_kernels"))
        assert all(row["equal"] for row in rows), rows

    def _parity_case(self, k, m, n, dtype, weighted, path, block_k=None,
                     variant=None, kind="contaminated"):
        """One kernel launch against its plain version on the same inputs;
        the case's row (``ok`` False where it disagrees).  ``kind``:
        contaminated (20% of the rows shifted by 1000), ties (multiples of
        0.5 under uniform weights) or all_equal (every 7th column one
        constant, the MAD floor, beside contaminated columns), massless
        (contaminated, the second K block's weights 0; with one K block
        every third row's) or exact_half (contaminated, 64 rows of weight
        1/64 a column, the rest 0: the sorted-order mass reaches exactly
        one half).  The plain version runs at most 2^20 columns at a time
        (fewer where K N is large), so its planes fit the card."""
        torch = self.torch
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk
        seed = k * 7919 + m + n + 104729 * PARITY_KINDS.index(kind)
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn((k, m), generator=g, device=self.dev)
        if kind == "ties":
            x = torch.round(x * 2.0) / 2.0 + 0.0       # no -0.0
        else:
            x[k - max(1, k // 5):] += 1000.0            # 20% contamination
        if kind == "all_equal":
            x[:, ::7] = 3.0
        x = x.to(dtype)
        plan = mk.launch_plan(k, m, n, dtype=dtype, block_k=block_k,
                              path=path, variant=variant)
        if not weighted:
            a = torch.full((k, 1), 1.0 / k, device=self.dev)
        elif kind == "ties":
            a = torch.full((k, n), 1.0 / k, device=self.dev)
        else:
            a = torch.rand((k, n), generator=g, device=self.dev) * 0.9 + 0.1
            if kind == "massless" and plan.num_k_blocks > 1:
                a[plan.block_k:2 * plan.block_k] = 0.0
            elif kind == "massless":
                a[::3] = 0.0
            elif kind == "exact_half":
                a.zero_()
                for j in range(n):
                    a[torch.randperm(k, generator=g, device=self.dev)[:64],
                      j] = 1.0
            a = location.normalize_weights(a, dtype=torch.float32)
        run = mk.two_pass if path == "two_pass" else mk.single_pass
        got = self.not_counted(lambda: run(x, a, plan, weighted=weighted))
        scale = max(1.0, float(x.float().abs().max()))
        err, ok = 0.0, True
        chunk = min(1 << 20, max(1024, (1 << 28) // (k * n)))
        for lo in range(0, m, chunk):
            xc = x[:, lo:lo + chunk]
            pc = mk.launch_plan(k, xc.shape[1], n, dtype=dtype,
                                block_k=plan.block_k, path=path,
                                variant=plan.variant)
            xp, ap = mk._pad_inputs(xc, a, plan=pc)
            if path == "two_pass":
                want = mk.mm_two_pass_plain(xp, ap, k=k, block_k=plan.block_k,
                                            weighted=weighted)
            else:
                want = mk.mm_single_pass_plain(xp, ap, k=k, weighted=weighted)
            want, gc = want[:, :xc.shape[1]], got[:, lo:lo + xc.shape[1]]
            d = (gc.float() - want.float()).abs()
            err = max(err, float(d.max()))
            if dtype == torch.float32:
                ok = ok and err <= 1e-5 * scale
            else:
                bits = (gc.view(torch.int16).int()
                        - want.view(torch.int16).int()).abs()
                ok = ok and bool(((bits <= 1) | (d <= 1e-5 * scale)).all())
            del xp, ap, want, d
        name = "two_pass" if path == "two_pass" else "single_pass"
        if dtype == torch.float32:
            self.parity_err[name] = max(self.parity_err[name], err)
        return {"kernel": name, "variant": plan.variant, "kind": kind,
                "k": k, "m": m, "n": n,
                "dtype": str(dtype).replace("torch.", ""), "weighted": weighted,
                "block_m": plan.block_m, "block_k": plan.block_k,
                "n_chunk": plan.n_chunk, "max_abs_err": err,
                "tol": 1e-5 * scale if dtype == torch.float32 else "1 ulp",
                "ok": ok}

    def parity(self):
        torch = self.torch
        from repro_torch.kernels import mm_aggregate as mk
        single = ((5, 130, 1, False), (32, 4099, 1, True), (32, 4099, 32, True),
                  (33, 1000, 5, True), (64, 8192, 1, False))
        rows = []
        for dtype in (torch.float32, torch.bfloat16):
            for k, m, n, w in single:
                rows.append(self._parity_case(k, m, n, dtype, w, "single"))
            for k, m, n, w, bk, kind in TWO_PASS_CASES:
                rows.append(self._parity_case(k, m, n, dtype, w, "two_pass",
                                              bk, kind=kind))
            for k, m, n, dname, w in TWO_PASS_WIDE:
                if mk._as_dtype(dname) == dtype:
                    rows.append(self._parity_case(k, m, n, dtype, w,
                                                  "two_pass"))
                    emit(dict(rows[-1], phase="parity_wide"))
                    torch.cuda.empty_cache()
            # every variant, forced through the plan, at every edge
            for variant in mk.SINGLE_PASS_VARIANTS:
                max_k = mk.VARIANT_MAX_K.get(variant, max(PARITY_K))
                for k in (k for k in PARITY_K if k <= max_k):
                    for m, n, w, kind in PARITY_EDGES:
                        rows.append(self._parity_case(
                            k, m, n, dtype, w, "single", variant=variant,
                            kind=kind))
        groups = {}
        for row in rows:
            g = groups.setdefault((row["kernel"], row["variant"], row["dtype"]),
                                  {"cases": 0, "failed": [], "max_abs_err": 0.0})
            g["cases"] += 1
            g["max_abs_err"] = max(g["max_abs_err"], row["max_abs_err"])
            if not row["ok"]:
                g["failed"].append(row)
        for (kernel, variant, dtype), g in groups.items():
            emit({"phase": "parity", "kernel": kernel, "variant": variant,
                  "dtype": dtype, "cases": g["cases"],
                  "max_abs_err": g["max_abs_err"],
                  "failed": g["failed"][:5], "n_failed": len(g["failed"])})
        bad = sum(len(g["failed"]) for g in groups.values())
        self.parity_err["finite_scan"] = self.finite_parity()
        bad += self.parity_err["finite_scan"]
        self.parity_err["residual"] = self.residual_parity()
        bad += self.parity_err["residual"]
        if bad:
            raise AssertionError(f"{bad} parity cases disagree with the "
                                 "plain version")

    def finite_parity(self) -> int:
        """ops.any_nonfinite on the card against torch.isfinite(x).all()
        and the kernel's plain version: every FINITE_LENGTHS x
        FINITE_OFFSETS view of f32 and bf16, finite and with each special
        at its first, middle and last element; f16, int32 and strided
        views, which it has to refuse; then FINITE_WIDE, each special
        last, first and in the middle, each timed as measure_finite times
        the service's checks.  Returns the failed cases."""
        torch = self.torch
        from repro_torch.kernels import launches as tally
        from repro_torch.kernels import ops
        dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
        failed, cases = [], 0
        launches0 = tally.total("finite_scan")

        def check(x, label):
            nonlocal cases
            cases += 1
            want = not bool(torch.isfinite(x).all())
            got = bool(ops.any_nonfinite(x))
            plain = bool(ops.any_nonfinite_plain(x))
            if got != want or plain != want:
                failed.append(dict(label, got=got, want=want, plain=plain))

        def refused(x, label):
            nonlocal cases
            cases += 1
            try:
                ops.any_nonfinite(x)
            except ValueError:
                return
            failed.append(dict(label, got="no error", want="ValueError"))

        for name, dtype in dtypes.items():
            for n in FINITE_LENGTHS:
                for off in FINITE_OFFSETS:
                    base = (torch.arange(n + off, device=self.dev) % 251).to(dtype)
                    view = base[off:]
                    label = {"dtype": name, "n": n, "offset": off}
                    check(view, dict(label, special=None))
                    if n == 0:
                        continue
                    for v in FINITE_SPECIALS:
                        for i in {0, n // 2, n - 1}:
                            view[i] = v
                            check(view, dict(label, special=v, at=i))
                            view[i] = 0
            refused(torch.zeros(1001, device=self.dev, dtype=dtype)[1::2],
                    {"dtype": name, "strided": True})
        for dtype in (torch.float16, torch.int32):
            refused(torch.zeros(64, device=self.dev, dtype=dtype),
                    {"dtype": str(dtype)})
        timings = []
        for name, n in FINITE_WIDE:
            x = torch.zeros(n, device=self.dev, dtype=dtypes[name])
            for v in FINITE_SPECIALS:
                for i in (n - 1, 0, n // 2):
                    x[i] = v
                    check(x, {"dtype": name, "n": n, "special": v, "at": i})
                    x[i] = 0
            check(x, {"dtype": name, "n": n, "special": None})
            x[n - 1] = float("nan")
            check(x[1:], {"dtype": name, "n": n - 1, "offset": 1,
                          "special": "nan", "at": n - 2})
            x[n - 1] = 0
            entry = self.measure_finite(None, f"{name} {n}", x, 0)
            timings.append({k: entry[k] for k in (
                "shape", "bytes", "ms", "call_ms", "profiler_ms", "bound_ms",
                "library_ms", "aminmax_ms", "profiler_kernels")})
            del x
            torch.cuda.empty_cache()
        emit({"phase": "parity", "kernel": "finite_scan", "cases": cases,
              "n_failed": len(failed), "failed": failed[:5],
              "launches": tally.total("finite_scan") - launches0,
              "timings": timings})
        return len(failed)

    def measure_finite(self, key, label, x, launches):
        """A finite_scan entry of the kernels line (recorded under ``key``
        unless it is None): ops.any_nonfinite on x timed as the other
        entries time their kernel -- ``ms`` over back-to-back checks,
        ``call_ms`` one at a time, ``profiler_ms`` finite_scan's
        torch.profiler device time -- beside x's bytes over 3.35 TB/s,
        the check the service ran before (``library_ms``:
        torch.isfinite(x).all()) and a library reduction that also reads x
        once (``aminmax_ms``: torch.aminmax(x) alone, before a verdict is
        drawn from its two values), with ``launches`` from the main-path
        run that gave the shape.  ``max_abs_err`` is 1 where its verdict
        on x differs from torch.isfinite's, else 0."""
        torch = self.torch
        from repro_torch.kernels import ops
        check = lambda: ops.any_nonfinite(x)
        err = abs(int(check()) - int(not bool(torch.isfinite(x).all())))
        call_ms, _ = self.time_ms(check)
        ms, _ = self.kernel_ms(check)
        _, by_name = self.profiler_ms(check)
        prof = sum(t for k, t in by_name.items() if "finite_scan" in k)
        library, _ = self.kernel_ms(lambda: torch.isfinite(x).all(), 10)
        aminmax, _ = self.kernel_ms(lambda: torch.aminmax(x), 10)
        nbytes = x.numel() * x.element_size()
        entry = dict(
            name=key, shape=label, variant="finite_scan", launches=launches,
            source="src/repro_torch/kernels/csrc/finite.cu",
            replaces="none: src/repro/serve/buffer.py:90 (np.isfinite)",
            max_abs_err=err, ms=ms, call_ms=call_ms, profiler_ms=prof or None,
            profiler_kernels=by_name, plain_ms=None,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=library, aminmax_ms=aminmax, bytes=nbytes)
        if key is not None:
            self.kernels[key] = entry
        return entry

    def residual_parity(self) -> int:
        """ops.residual_norms on the card against its plain version
        (rtol 1e-5: it sums squares in f32) and a float64 sum of the same
        f32 differences (rtol 2.5e-7, 2 ulp): RESIDUAL_ROWS x
        RESIDUAL_LENGTHS, rows and centre as views at storage offsets 0-3
        (the 16-byte alignments the kernel meets), a row + 1000, and the
        same bits on a repeat; one launch a call.  Then RESIDUAL_WIDE,
        each timed by measure_residual.  Returns the failed cases."""
        torch = self.torch
        from repro_torch.kernels import launches as tally
        from repro_torch.kernels import ops
        failed, cases, worst = [], 0, 0.0

        def check(rows, center, label):
            nonlocal cases, worst
            cases += 1
            before = tally.total("residual")
            got = ops.residual_norms(rows, center)
            again = ops.residual_norms(rows, center)
            want = torch.stack([torch.linalg.vector_norm(
                (r - center).double()) for r in rows])
            plain = ops.residual_norms_plain(rows, center).double()
            rel = float(((got.double() - want).abs()
                         / want.clamp_min(1e-30)).max())
            rel_plain = float(((got.double() - plain).abs()
                               / plain.clamp_min(1e-30)).max())
            worst = max(worst, rel)
            ok = (rel <= 2.5e-7 and rel_plain <= 1e-5
                  and bool(torch.equal(got, again))
                  and tally.total("residual") - before == 2)
            if not ok:
                failed.append(dict(label, rel=rel, rel_plain=rel_plain,
                                   repeat=bool(torch.equal(got, again))))

        g = torch.Generator(device=self.dev).manual_seed(11)
        for n in RESIDUAL_ROWS:
            for m in RESIDUAL_LENGTHS:
                x = torch.randn((n + 1, m + 3), generator=g, device=self.dev)
                rows = [x[i, :m] for i in range(n)]
                check(rows, x[n, 3:], {"n": n, "m": m})
                if m > 1000:
                    check([x[i, i % 4:i % 4 + m] for i in range(n)],
                          x[n, 1:1 + m], {"n": n, "m": m, "offsets": True})
                    x[n - 1, :m] += 1000.0
                    check(rows, x[n, :m], {"n": n, "m": m, "shift": 1000.0})
                del x
        timings = []
        for n, m in RESIDUAL_WIDE:
            x = torch.randn((n + 1, m), generator=g, device=self.dev)
            x[n - 2] += 1000.0
            rows, center = list(x[:n].unbind()), x[n]
            check(rows, center, {"n": n, "m": m})
            entry = self.measure_residual(None, f"{n} x {m}", rows, center, 0)
            timings.append({k: entry[k] for k in (
                "shape", "bytes", "ms", "call_ms", "profiler_ms", "bound_ms",
                "plain_ms", "profiler_kernels")})
            del x, rows, center
            torch.cuda.empty_cache()
        emit({"phase": "parity", "kernel": "residual_norms", "cases": cases,
              "n_failed": len(failed), "failed": failed[:5],
              "max_rel_err_vs_float64": worst, "timings": timings})
        return len(failed)

    def measure_residual(self, key, label, rows, center, launches):
        """A residual_norms entry of the kernels line (recorded under
        ``key`` unless it is None): ops.residual_norms(rows, center)
        timed as the other entries time their kernel -- ``ms`` over
        back-to-back calls, ``call_ms`` one at a time, ``profiler_ms``
        the device time of its two kernels -- beside the rows' and the
        centre's bytes over 3.35 TB/s and the eager loop the service ran
        before (``plain_ms``: vector_norm(row - center) row by row), with
        ``launches`` from the main-path run that gave the shape."""
        torch = self.torch
        from repro_torch.kernels import ops
        call = lambda: ops.residual_norms(rows, center)
        eager = lambda: ops.residual_norms_plain(rows, center)
        call_ms, got = self.time_ms(call)
        ms, _ = self.kernel_ms(call, 10)
        _, by_name = self.profiler_ms(call, 5)
        prof = sum(t for k, t in by_name.items() if "residual_" in k)
        plain_ms, plain = self.kernel_ms(eager, 3)
        err = float(((got - plain).abs() / plain.abs().clamp_min(1e-30)).max())
        nbytes = (len(rows) + 1) * center.numel() * 4
        entry = dict(
            name=key, shape=label, variant="residual_norms", launches=launches,
            source="src/repro_torch/kernels/csrc/residual.cu",
            replaces="none: the service's residual check and step norm",
            max_abs_err=err, ms=ms, call_ms=call_ms, profiler_ms=prof or None,
            profiler_kernels=by_name, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes=nbytes)
        if key is not None:
            self.kernels[key] = entry
        return entry

    def captured_run(self, spec):
        """A spec's captured run held to the eager loop: runner.loop on
        the spec's lowering, state and seed, then a miss and a hit of
        scenarios.run (trace_spec, then one CUDA-graph replay), each a
        main path.  Gates: the program is one captured graph; both
        histories bit-equal to the loop's; the hit's compile_s 0.0 and
        its launch counts the loop's, the miss's the loop's plus its
        warm-up step.  Returns (miss, its counts, its variants, the
        phase's numbers: compile_s, wall_clock_s of the miss and the
        hit, the eager loop's seconds, the hit's device busy share)."""
        torch = self.torch
        import numpy as np
        from repro_torch import scenarios
        from repro_torch.scenarios import runner
        low, state, gen = runner._lowered_state(spec, self.dev)
        t0 = time.perf_counter()
        (_, hist), eager_counts, _ = self.main_path(
            lambda: runner.loop(low.step_fn, state, gen, spec.num_steps))
        eager_s = time.perf_counter() - t0
        eager = {name: torch.stack(v).cpu().numpy()
                 for name, v in hist.items()}
        del low, state, gen, hist
        runner.clear_executable_cache()
        miss, counts, variants = self.main_path(lambda: scenarios.run(spec))
        hit, hit_counts, _ = self.main_path(lambda: scenarios.run(spec))
        program = runner._EXEC_CACHE[runner._exec_cache_key(spec, self.dev)]
        assert program.captured and program.graph is not None, spec
        assert not miss.compile_cache_hit and miss.compile_s > 0.0, miss
        assert hit.compile_cache_hit and hit.compile_s == 0.0, hit
        for name, want in eager.items():
            assert np.array_equal(miss.history[name], want), \
                (spec.label(), name, "the captured run left the eager loop")
            assert np.array_equal(hit.history[name], want), \
                (spec.label(), name, "a cache hit left the eager loop")
        per_step = {kind: n // spec.num_steps
                    for kind, n in eager_counts.items()}
        assert hit_counts == eager_counts, (hit_counts, eager_counts)
        assert counts == {kind: n + per_step[kind]
                          for kind, n in eager_counts.items()}, \
            (counts, eager_counts)
        busy = self.not_counted(lambda: self.device_busy_share(
            lambda: scenarios.run(spec)))
        return miss, counts, variants, {
            "compile_s": miss.compile_s, "miss_wall_s": miss.wall_clock_s,
            "hit_compile_s": hit.compile_s, "hit_wall_s": hit.wall_clock_s,
            "eager_loop_s": eager_s, "compile_split_s": program.timings,
            "hit_device_busy_share": busy,
            "hit_kernels": self.busy_kernels,
            "eager_launches": eager_counts, "hit_launches": hit_counts,
            "histories_equal_eager": True,
            "graph_launch_records": [[*key, n] for key, n
                                     in program.launches.items()]}

    def paper(self):
        from repro_torch import scenarios
        from repro_torch.configs import paper_lsq

        def spec(agg, backend):
            return scenarios.ScenarioSpec(
                paradigm="diffusion", num_agents=paper_lsq.NUM_AGENTS,
                dim=paper_lsq.DIM, noise_var=paper_lsq.NOISE_VAR,
                topology="fully_connected", aggregator=agg, backend=backend,
                attack="additive", num_malicious=1,
                attack_kwargs=(("delta", 1000.0),),
                step_size=paper_lsq.STEP_SIZE, num_steps=500, seed=0,
                data_seed=0)

        # the C3 spec, captured, against the eager loop (a miss, a hit)
        ref, counts, variants, ref_run = self.captured_run(
            spec("mm_tukey", "pallas"))
        steady = ref.summary["steady_msd"]
        assert variants["warp"] == counts["single_pass"] > 0, variants
        assert steady < 1e-2, steady
        mean = scenarios.run(spec("mean", "jnp"))
        fed_spec = scenarios.ScenarioSpec(
            paradigm="federated", num_agents=32, participation=0.5,
            local_steps=5, dim=10, noise_var=0.01, step_size=0.05,
            num_steps=300, attack="additive",
            attack_kwargs=(("delta", 1000.0),), aggregator="mm_tukey",
            num_malicious=6, backend="pallas")
        fed, fcounts, fvariants, fed_run = self.captured_run(fed_spec)
        assert fvariants["warp"] == fcounts["single_pass"] > 0, fvariants
        assert fed.finite(), fed.history
        # the stacked sharded lowering: one robust aggregate of K = 32
        # agents' gradients a step
        sharded, scounts, svariants, sharded_run = self.captured_run(
            scenarios.ScenarioSpec(
                paradigm="sharded", num_agents=32, dim=10, step_size=0.05,
                num_steps=300, attack="additive",
                attack_kwargs=(("delta", 1000.0),), aggregator="mm_tukey",
                num_malicious=6, backend="pallas"))
        assert svariants["warp"] == scounts["single_pass"] > 0, svariants
        assert sharded.finite(), sharded.history
        # one diffusion step's launch: (K, M, N) = (32, 10, 32)
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk
        g = self.torch.Generator(device=self.dev).manual_seed(2)
        x = self.torch.randn((32, 10), generator=g, device=self.dev)
        x[31] += 1000.0
        a = location.normalize_weights(
            self.torch.ones((32, 32), device=self.dev))
        step = self.measure("mm_single_pass (paper diffusion step)",
                            "K=32 M=10 N=32 f32", x, a,
                            mk.launch_plan(32, 10, 32), counts, variants)
        # one federated round's launch: the cohort, unweighted
        kc = fed_spec.clients_per_round()
        xc = self.torch.randn((kc, 10), generator=g, device=self.dev)
        xc[kc - 3:] += 1000.0
        self.measure("mm_single_pass (federated round)",
                     f"K={kc} M=10 N=1 f32", xc,
                     self.torch.full((kc, 1), 1.0 / kc, device=self.dev),
                     mk.launch_plan(kc, 10, 1), fcounts, fvariants,
                     weighted=False)
        # one stacked sharded step's launch: the 32 agents' gradients,
        # unweighted
        xs = self.torch.randn((32, 10), generator=g, device=self.dev)
        xs[26:] += 1000.0
        self.measure("mm_single_pass (stacked sharded step)",
                     "K=32 M=10 N=1 f32", xs,
                     self.torch.full((32, 1), 1.0 / 32, device=self.dev),
                     mk.launch_plan(32, 10, 1), scounts, svariants,
                     weighted=False)
        emit({"phase": "paper", "ref_steady_msd": steady,
              "step_launch_ms": step["ms"], "ref_launches": counts,
              "ref_variants": variants, "ref": ref_run,
              "mean_steady_msd": mean.summary["steady_msd"],
              "mean_broke_down": mean.summary["broke_down"],
              "fed_mm_msd_at_50": float(fed.history["msd"][49]),
              "fed_mm_final_msd": fed.final_msd, "fed_launches": fcounts,
              "fed_variants": fvariants, "fed": fed_run,
              "sharded_final_msd": sharded.final_msd,
              "sharded_launches": scounts, "sharded_variants": svariants,
              "sharded": sharded_run})

    def cohort(self):
        from repro_torch import scenarios
        sp = scenarios.ScenarioSpec(
            paradigm="federated", aggregator="mm_tukey", backend="pallas",
            attack="additive", num_agents=1024, dim=256, num_steps=3,
            num_malicious=128, participation=0.5, seed=0)
        res, counts, variants, captured = self.captured_run(sp)
        assert counts["two_pass"] > 0, counts
        assert res.finite(), res.history
        audit = res.launch_audit
        x = self.torch.randn((512, 256), device=self.dev)
        x[448:] += 1000.0
        a = self.torch.full((512, 1), 1.0 / 512, device=self.dev)
        from repro_torch.kernels import mm_aggregate as mk
        plan = mk.launch_plan(512, 256, 1, block_m=audit["block_m"],
                              block_k=audit["block_k"], path="two_pass")
        entry = self.measure("mm_two_pass", "K=512 M=256 N=1 f32 "
                             "(large_cohort)", x, a, plan, counts, variants,
                             weighted=False)
        ms, pms, err = entry["ms"], entry["plain_ms"], entry["max_abs_err"]
        emit({"phase": "cohort", "msd": [float(v) for v in res.history["msd"]],
              "launches": counts, "audit": audit, "ms": ms,
              "call_ms": entry["call_ms"], "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"], "plain_ms": pms,
              "max_abs_err": err, "blocks": mk.two_pass_blocks(
                  plan, 512, weighted=False), "captured": captured})

    def qwen3_updates(self, seed: int):
        """WIDTH_AGENTS updates shaped like Qwen3-0.6B's parameter tree,
        made on the card from ``seed``, the last agent shifted by 1000:
        (stacked leaves, the tree of them)."""
        torch = self.torch
        from repro_torch import pytree
        leaves_shapes, treedef = qwen3_shapes()
        k = WIDTH_AGENTS
        g = torch.Generator(device=self.dev).manual_seed(seed)
        leaves = []
        for shape in leaves_shapes:
            leaf = torch.randn((k,) + tuple(shape), generator=g,
                               device=self.dev)
            leaf[k - 1] += 1000.0                # one byzantine agent
            leaves.append(leaf)
        return leaves, pytree.unflatten(treedef, leaves)

    def width(self):
        torch = self.torch
        from repro_torch.kernels import mm_aggregate as mk, ops
        leaves_shapes, _ = qwen3_shapes()
        k = WIDTH_AGENTS
        leaves, tree = self.qwen3_updates(0)
        m_total = sum(math.prod(s) for s in leaves_shapes)
        engine = ops.AggregationEngine()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, counts, variants = self.main_path(
            lambda: engine.aggregate_tree(tree))
        tree_ms = (time.perf_counter() - t0) * 1e3  # stage + launch + split
        peak = torch.cuda.max_memory_allocated()
        assert counts == {"single_pass": 1, "two_pass": 0}, counts
        assert variants["regs"] == 1, variants
        uniform = torch.full((k, 1), 1.0 / k, device=self.dev)

        def plain(x):
            return mk.mm_single_pass_plain(x.contiguous(), uniform, k=k,
                                           weighted=False)[0]

        windows = {}
        # the first 2^20 coordinates of embed, 2^20 from the middle of
        # w_down (layer 14 of 28), all of ln_f
        checks = (("embed", ("embed",), 0, 2 ** 20),
                  ("blocks.mlp.w_down", ("blocks", "mlp", "w_down"), 0.5,
                   2 ** 20),
                  ("ln_f", ("ln_f",), 0, None))
        for label, path, start, width in checks:
            src, got = tree, out
            for p in path:
                src, got = src[p], got[p]
            lo = int(start * got.numel())
            sl = slice(lo, None if width is None else lo + width)
            want = plain(src.reshape(k, -1)[:, sl])
            err = float((got.reshape(-1)[sl] - want).abs().max())
            assert bool(torch.isfinite(got).all()), label
            assert err <= 1e-5 * 1001.0, (label, err)
            windows[label] = err
        del out, tree
        buf = ops.stage_leaves(leaves)
        del leaves
        plan = mk.launch_plan(k, m_total, 1)
        assert plan.variant == "regs", plan
        call = lambda: mk.single_pass(buf, uniform, plan, weighted=False)[0]
        call_ms, _ = self.not_counted(lambda: self.time_ms(call))
        ms, est = self.not_counted(lambda: self.kernel_ms(call))
        prof, prof_kernels = self.not_counted(
            lambda: self.profiler_ms(call, launches=3))
        # the plain version over every column, in chunks it can hold
        chunk = 2 ** 24
        err, plain_ms = 0.0, 0.0
        for lo in range(0, m_total, chunk):
            x = buf[:, lo:lo + chunk]
            t, want = self.time_ms(lambda: plain(x), reps=1, warmup=0)
            plain_ms += t
            err = max(err, float((est[lo:lo + chunk] - want).abs().max()))
        assert err <= 1e-5 * 1001.0, err
        del buf, est, x, want, call, src, got
        _ = None               # time_ms's last result: a 3.01 GB estimate
        compiled = self._width_compiled(tree_ms)
        gbs = plan.total_bytes / (ms * 1e-3) / 1e9
        t_bytes = plan.total_bytes / HBM_BYTES_PER_S * 1e3
        t, by = bound(plan.total_bytes, mm_ops(k, m_total, 1, False))
        self.kernels["mm_single_pass"] = dict(
            name="mm_single_pass",
            shape=f"K={k} M={m_total} N=1 f32 (Qwen3-0.6B tree)",
            variant=plan.variant, launches=counts["single_pass"],
            source="src/repro_torch/kernels/csrc/mm_single_pass.cu",
            replaces="src/repro/kernels/mm_aggregate.py:243", max_abs_err=err,
            ms=ms, call_ms=call_ms, profiler_ms=prof,
            profiler_kernels=prof_kernels, plain_ms=plain_ms,
            bound_ms=t, bound_by=by, library_ms=None)
        emit({"phase": "width", "leaves": len(leaves_shapes),
              "m_total": m_total, "launches": counts, "window_err": windows,
              "max_abs_err_all_columns": err, "tree_ms": tree_ms, "ms": ms,
              "call_ms": call_ms, "profiler_ms": prof, "plain_ms": plain_ms,
              "bound_share": t / ms, "variant": plan.variant,
              "total_bytes": plan.total_bytes, "gb_per_s": gbs,
              "hbm_bound_ms": t_bytes, "hbm_bound_share": t_bytes / ms,
              "bound_ms": t, "bound_by": by, "block_m": plan.block_m,
              "max_memory_allocated": peak, "compiled": compiled})

    def _width_compiled(self, tree_ms):
        """The tree program and leaf donation at full width: K = 8
        Qwen3-0.6B-shaped updates (24.06 GB of leaves) made anew from the
        same seed for each call.  aggregate_tree's estimate goes to the
        host (3.01 GB); engine.lower_tree(tree).compile() (a warm-up and
        a CUDA-graph capture of kernel->split) is called once as a main
        path (one launch, from its replay) and must give that estimate
        bit for bit; then AggregationEngine(donate_leaves=True)'s
        aggregate_tree and tree program, each from fresh leaves: the
        same estimate, every leaf 0 bytes afterwards.  The plain and the
        donated aggregate_tree's max_memory_allocated are taken from
        the same start (the leaves alone on the card, the estimate of
        the other on the host); donation must lower the peak by at least
        2.9 GB (the estimate's 3.01 GB).  Times: aggregate_tree and a
        program call (stage + replay), CUDA events, median of 3."""
        torch = self.torch
        from repro_torch import pytree
        from repro_torch.kernels import ops
        gb = 1e9

        def fresh_tree():
            leaves, tree = self.qwen3_updates(0)
            del leaves[:]
            return tree

        def peak_of(fn):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = self.not_counted(fn)
            torch.cuda.synchronize()
            return out, start, torch.cuda.max_memory_allocated()

        def equal_to(want, out):
            return all(torch.equal(o.cpu(), w) for o, w in
                       zip(pytree.flatten(out)[0], want))

        engine = ops.AggregationEngine()
        tree = fresh_tree()
        out, start_plain, peak_plain = peak_of(
            lambda: engine.aggregate_tree(tree))
        want = [leaf.cpu() for leaf in pytree.flatten(out)[0]]
        del out
        eager_ms = self.not_counted(
            lambda: self.time_ms(lambda: engine.aggregate_tree(tree)))[0]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        program = self.not_counted(lambda: engine.lower_tree(tree).compile())
        compile_s = time.perf_counter() - t0
        out, counts, variants = self.main_path(lambda: program(tree))
        program_peak = torch.cuda.max_memory_allocated()
        assert counts == {"single_pass": 1, "two_pass": 0}, counts
        assert variants["regs"] == 1 and program.graph is not None, variants
        assert equal_to(want, out), "the tree program left aggregate_tree"
        program_ms = self.not_counted(
            lambda: self.time_ms(lambda: program(tree)))[0]
        del out, program, tree

        donating = ops.AggregationEngine(donate_leaves=True)
        tree = fresh_tree()
        out, start_donated, peak_donated = peak_of(
            lambda: donating.aggregate_tree(tree))
        held = [leaf.untyped_storage().nbytes()
                for leaf in pytree.flatten(tree)[0]]
        assert equal_to(want, out), "donation changed the estimate"
        assert not any(held), held
        del out, tree
        tree = fresh_tree()
        program = self.not_counted(
            lambda: donating.lower_tree(tree).compile())
        assert all(donating.lower_tree(tree).donated)
        out = self.not_counted(lambda: program(tree))
        held_program = [leaf.untyped_storage().nbytes()
                        for leaf in pytree.flatten(tree)[0]]
        assert equal_to(want, out), "the donated program left aggregate_tree"
        assert not any(held_program), held_program
        del out, program, tree, want
        torch.cuda.empty_cache()
        drop = peak_plain - peak_donated
        assert abs(start_donated - start_plain) < 0.01 * gb, \
            (start_plain, start_donated)
        assert drop >= 2.9 * gb, (peak_plain, peak_donated)
        return {"tree_ms_host": tree_ms, "aggregate_tree_ms": eager_ms,
                "program_compile_s": compile_s, "program_ms": program_ms,
                "program_launches": counts, "program_equal": True,
                "program_peak": program_peak,
                "start_plain": start_plain, "start_donated": start_donated,
                "max_memory_allocated_plain": peak_plain,
                "max_memory_allocated_donated": peak_donated,
                "peak_drop": drop, "donated_equal": True,
                "donated_leaf_bytes": sum(held) + sum(held_program)}

    def batch(self):
        torch = self.torch
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk, ops
        k, m, n = 32, 2 ** 20, 32
        g = torch.Generator(device=self.dev).manual_seed(1)
        x = torch.randn((k, m), generator=g, device=self.dev)
        x[k - 1] += 1000.0
        a = location.normalize_weights(
            torch.rand((k, n), generator=g, device=self.dev) + 0.1)
        # the engine's batched entry point, as diffusion_step calls it
        out, counts, variants = self.main_path(
            lambda: ops.AggregationEngine().aggregate_batched(x, a))
        assert counts == {"single_pass": 1, "two_pass": 0}, counts
        assert variants["regs"] == 1, variants
        assert out.shape == (n, m) and bool(torch.isfinite(out).all())
        del out
        plan = mk.launch_plan(k, m, n)
        entry = self.measure("mm_single_pass (diffusion batch)",
                             f"K={k} M={m} N={n} f32", x, a, plan, counts,
                             variants)
        ms, pms, err = entry["ms"], entry["plain_ms"], entry["max_abs_err"]
        t, by = entry["bound_ms"], entry["bound_by"]
        emit({"phase": "batch", "k": k, "m": m, "n": n, "ms": ms,
              "call_ms": entry["call_ms"], "profiler_ms": entry["profiler_ms"],
              "variant": plan.variant,
              "plain_ms": pms, "max_abs_err": err, "bound_ms": t,
              "bound_by": by, "block_m": plan.block_m,
              "total_bytes": plan.total_bytes, "launches": counts})
        del x, a
        # fully connected diffusion over 256 agents: (256, 2^16, 256),
        # weighted, on the two-pass kernel (its weights staged 64 columns
        # of N at a time)
        k, m, n = 256, 2 ** 16, 256
        x = torch.randn((k, m), generator=g, device=self.dev)
        x[k - k // 5:] += 1000.0
        a = location.normalize_weights(
            torch.rand((k, n), generator=g, device=self.dev) + 0.1)
        out, counts, variants = self.main_path(
            lambda: ops.AggregationEngine().aggregate_batched(x, a))
        assert counts == {"single_pass": 0, "two_pass": 1}, counts
        assert out.shape == (n, m) and bool(torch.isfinite(out).all())
        del out
        plan = mk.launch_plan(k, m, n)
        entry = self.measure("mm_two_pass (diffusion batch, 256 agents)",
                             f"K={k} M={m} N={n} f32", x, a, plan, counts,
                             variants, launches=10, chunk=4096)
        emit({"phase": "batch", "k": k, "m": m, "n": n, "ms": entry["ms"],
              "call_ms": entry["call_ms"], "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "variant": "two_pass", "plain_ms": entry["plain_ms"],
              "max_abs_err": entry["max_abs_err"],
              "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
              "block_m": plan.block_m, "block_k": plan.block_k,
              "n_chunk": plan.n_chunk, "smem_bytes": plan.smem_bytes,
              "blocks": mk.two_pass_blocks(plan, k),
              "total_bytes": plan.total_bytes, "launches": counts})

    def cohort_width(self):
        torch = self.torch
        from repro_torch.kernels import mm_aggregate as mk, ops
        m = layer_width()
        k = COHORT_K
        torch.cuda.empty_cache()  # the earlier phases' cached blocks
        g = torch.Generator(device=self.dev).manual_seed(3)
        x = torch.randn((k, m), generator=g, device=self.dev)
        x[k - COHORT_BAD:] += 1000.0
        engine = ops.AggregationEngine()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, counts, variants = self.main_path(lambda: engine.aggregate(x))
        peak = torch.cuda.max_memory_allocated()
        assert counts == {"single_pass": 0, "two_pass": 1}, counts
        assert out.shape == (m,) and bool(torch.isfinite(out).all())
        plan = mk.launch_plan(k, m, 1)
        assert plan.path == "two_pass" and plan.num_k_blocks == 1, plan
        uniform = torch.full((k, 1), 1.0 / k, device=self.dev)
        est = self.not_counted(
            lambda: mk.two_pass(x, uniform, plan, weighted=False))
        assert torch.equal(est[0], out), "the engine and the wrapper disagree"
        del out, est
        entry = self.measure(
            "mm_two_pass (large-cohort layer)",
            f"K={k} M={m} N=1 f32 (one Qwen3-0.6B decoder layer)", x,
            uniform, plan, counts, variants, weighted=False, launches=10,
            chunk=2 ** 20)
        ms, t = entry["ms"], entry["bound_ms"]
        t_bytes = plan.total_bytes / HBM_BYTES_PER_S * 1e3
        emit({"phase": "cohort_width", "k": k, "m": m, "launches": counts,
              "ms": ms, "call_ms": entry["call_ms"],
              "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "plain_ms": entry["plain_ms"],
              "max_abs_err_all_columns": entry["max_abs_err"],
              "bound_ms": t, "bound_by": entry["bound_by"],
              "bound_share": t / ms, "hbm_bound_ms": t_bytes,
              "gb_per_s": plan.total_bytes / (ms * 1e-3) / 1e9,
              "total_bytes": plan.total_bytes, "block_m": plan.block_m,
              "block_k": plan.block_k, "smem_bytes": plan.smem_bytes,
              "blocks": mk.two_pass_blocks(plan, k, weighted=False),
              "max_memory_allocated": peak})

    def coarse_keys(self):
        torch = self.torch
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk
        k, width, m = 128, layer_width(), 1 << 20
        torch.cuda.empty_cache()  # the earlier phases' cached blocks
        shares = {"cohort": (0.005, 0.06), "narrow": (0.0, 0.0),
                  "clustered": (1.0, 1.0)}
        for kind, (lo, hi) in shares.items():
            g = torch.Generator(device=self.dev).manual_seed(32)
            x = torch.randn((k, width), generator=g, device=self.dev)
            if kind == "cohort":
                x[k - k // 8:] = x[0] + 1000.0
            elif kind == "narrow":
                x.mul_(1e-3).add_(1000.0)
            else:
                x.copy_(1.0 + torch.randint(0, 100, (k, width), generator=g,
                                            device=self.dev).float()
                        * 2.0 ** -23)
                x[0], x[1] = -1000.0, 1000.0
            a = torch.rand(k, generator=g, device=self.dev) + 0.5
            aw = location.normalize_weights(a.reshape(k, 1),
                                            dtype=torch.float32)
            row = {"phase": "coarse_keys", "kind": kind, "k": k}
            for cols in (m, width):
                xs = x[:, :cols]
                table = mk.RowTable(torch.tensor(
                    [r.data_ptr() for r in xs], dtype=torch.int64,
                    device=self.dev), cols, xs.dtype)
                plan = mk.launch_plan(k, cols, 1, table=True)
                assert plan.num_k_blocks == 1 and \
                    mk.two_pass_rows(plan.block_k) == 16, plan
                lanes = mk.two_pass_lanes(plan.block_k)
                warp_tiles = -(-cols // plan.block_m) * \
                    max(1, plan.block_m * lanes // 32)
                mk.two_pass_exact_tiles()         # reset the count
                got = self.not_counted(lambda: mk.two_pass(table, aw, plan))
                share = mk.two_pass_exact_tiles() / warp_tiles
                row[f"exact_share_{cols}"] = share
                assert lo <= share <= hi, (kind, cols, share)
                if cols == m:
                    eager = self.not_counted(lambda: mk.two_pass(xs, aw, plan))
                    assert torch.equal(got, eager), kind
                    xp, ap = mk._pad_inputs(xs.contiguous(), aw, plan=plan)
                    want = mk.mm_two_pass_plain(xp, ap, k=k,
                                                block_k=plan.block_k)
                    row["max_abs_err"] = float((got - want).abs().max())
                    row["tol"] = 1e-5 * max(1.0, float(xs.abs().max()))
                    assert row["max_abs_err"] <= row["tol"], row
                    del xp, ap, want, eager
                else:
                    row["ms"], _ = self.kernel_ms(
                        lambda: self.not_counted(
                            lambda: mk.two_pass(table, aw, plan)),
                        launches=20)
                    row["block_m"] = plan.block_m
                del got
            emit(row)
            del x

    # -- the autotuner and the entry points --------------------------------

    def autotune(self):
        """tuning.autotune at AUTOTUNE_SHAPES with the winners persisted to
        a file of a temporary directory; the gates (a)-(d) of the module
        docstring; then the cache emptied and the file forgotten."""
        import os
        import tempfile
        torch = self.torch
        from repro_torch.kernels import mm_aggregate as mk, ops, tuning
        torch.cuda.empty_cache()
        tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tuning_")
        os.environ[tuning.ENV_CACHE_PATH] = os.path.join(tmp.name,
                                                         "tuning.json")
        tuning.clear_cache()
        timed = []
        real = tuning._time_call_us

        def counted(fn, **kw):
            timed.append(1)
            return real(fn, **kw)

        tuning._time_call_us = counted
        try:
            winners = {}
            for label, k, m, n in autotune_shapes():
                t0 = time.perf_counter()
                tuning.autotune(k, m, n, device=self.dev)
                seconds = time.perf_counter() - t0
                sweep = tuning.sweep_times(k, m, n, device=self.dev)
                assert [c for c, _ in sweep] == \
                    tuning.candidate_choices(k, m, n), sweep
                win = tuning.get_choice(k, m, n)
                ms = {c: us * 1e-3 for c, us in sweep}
                heur = tuning.heuristic_choice(k, m, n)
                emit({"phase": "autotune", "shape": label, "k": k, "m": m,
                      "n": n, "seconds": seconds,
                      "candidates": [dict(c._asdict(), variant=mk.launch_plan(
                          k, m, n, block_m=c.block_m, block_k=c.block_k,
                          path=c.path).variant or "two_pass", ms=t)
                          for c, t in ms.items()],
                      "winner": win._asdict(), "winner_ms": ms[win],
                      "heuristic": heur._asdict(), "heuristic_ms": ms[heur],
                      "winner_is_heuristic": win == heur})
                winners[(k, m, n)] = win
            # (a) a fresh process with this environment reads them back
            code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
                    "from repro_torch.kernels import tuning; "
                    "print(json.dumps([list(tuning.get_choice(*s)) "
                    "for s in json.loads(sys.argv[2])]))")
            proc = subprocess.run(
                [sys.executable, "-c", code, str(HERE / "src"),
                 json.dumps([list(s) for s in winners])],
                capture_output=True, text=True, check=True,
                env=dict(os.environ))
            read = [tuning.TuneChoice(*c) for c in
                    json.loads(proc.stdout.strip().splitlines()[-1])]
            assert read == list(winners.values()), (read, winners)
            # (d) a second autotune without force times nothing
            n_timed = len(timed)
            for k, m, n in winners:
                tuning.autotune(k, m, n, device=self.dev)
            assert len(timed) == n_timed, "a cached workload was timed again"
            # (b), (c) the engine launches each winner
            engine = ops.AggregationEngine(autotune=True)
            (tree, cohort, _) = autotune_shapes()
            tree_row = self._autotuned_tree(engine, winners[tree[1:]])
            cohort_row = self._autotuned_cohort(engine, winners[cohort[1:]])
            emit({"phase": "autotune", "fresh_process_read": True,
                  "second_call_timed": len(timed) - n_timed,
                  "timed_calls": n_timed, "engine": [tree_row, cohort_row]})
        finally:
            tuning._time_call_us = real
            tuning.clear_cache()
            os.environ.pop(tuning.ENV_CACHE_PATH, None)
            tmp.cleanup()

    def _engine_launch(self, win, k, m, fn, stage, key, label, chunk,
                       launches):
        """Run ``fn`` (the autotuning engine over a (k, m) workload, which
        returns the (m,) estimate) as a main path.  Gates: its one launch
        took the winner's plan (the workload record, the counts by shape);
        the wrapper's launch of that plan on the buffer the engine read
        (``stage()``) gives the same bits; the plain version of the plan
        agrees over every column (``measure``).  Returns a row."""
        torch = self.torch
        from repro_torch.kernels import mm_aggregate as mk, ops
        plan = mk.launch_plan(k, m, 1, block_m=win.block_m,
                              block_k=win.block_k, path=win.path)
        with ops.record_workloads() as rec:
            est, counts, variants = self.main_path(fn)
        assert [(r["block_m"], r["block_k"], r["path"]) for r in rec] == \
            [(plan.block_m, plan.block_k, plan.path)], (rec, plan)
        assert self.by_shape == {(plan.variant or "two_pass", k, m, 1): 1}, \
            self.by_shape
        x = stage()
        torch.cuda.empty_cache()
        uniform = torch.full((k, 1), 1.0 / k, device=self.dev)
        run = mk.two_pass if plan.path == "two_pass" else mk.single_pass
        got = self.not_counted(lambda: run(x, uniform, plan, weighted=False))
        assert torch.equal(got[0], est), "the engine and the wrapper disagree"
        del got, est
        name = "mm_two_pass" if plan.path == "two_pass" else "mm_single_pass"
        entry = self.measure(
            f"{name} (autotuned, {key})",
            f"K={k} M={m} N=1 f32 ({label}, autotune winner)", x, uniform,
            plan, counts, variants, weighted=False, launches=launches,
            chunk=chunk)
        return {"shape": key, "variant": plan.variant or "two_pass",
                "block_m": plan.block_m, "block_k": plan.block_k,
                "launches": counts, "ms": entry["ms"],
                "max_abs_err_all_columns": entry["max_abs_err"],
                "bound_ms": entry["bound_ms"]}

    def _autotuned_tree(self, engine, win):
        torch = self.torch
        from repro_torch import pytree
        from repro_torch.kernels import ops
        # the updates live only here: staging them for the checks frees
        # them, so the card never holds the tree and two copies of x
        held = dict(zip(("leaves", "tree"), self.qwen3_updates(8)))

        def run():
            out = engine.aggregate_tree(held["tree"])
            return torch.cat([leaf.reshape(-1)
                              for leaf in pytree.flatten(out)[0]])

        def stage():
            buf = ops.stage_leaves(held.pop("leaves"))
            held.clear()
            return buf

        return self._engine_launch(
            win, WIDTH_AGENTS, QWEN3_0P6B_PARAMS, run, stage,
            "Qwen3-0.6B tree", "aggregate_tree", 2 ** 24, 50)

    def _autotuned_cohort(self, engine, win):
        torch = self.torch
        k, m = SERVE_COHORT_K, layer_width()
        g = torch.Generator(device=self.dev).manual_seed(9)
        x = torch.randn((k, m), generator=g, device=self.dev)
        x[k - SERVE_COHORT_BAD:] += 1000.0
        return self._engine_launch(
            win, k, m, lambda: engine.aggregate(x), lambda: x,
            "128-client cohort layer", "aggregate", 2 ** 20, 10)

    def _example(self, name, argv):
        """``python -m repro_torch.examples.<name> <argv>``'s main, in this
        process as a main path: (exit code, its standard output, launches,
        launches by (variant, K, M, N), seconds)."""
        import contextlib
        import importlib
        import io
        module = importlib.import_module(f"repro_torch.examples.{name}")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc, counts, _ = self.main_path(lambda: module.main(argv))
        return rc, out.getvalue(), counts, dict(self.by_shape), \
            time.perf_counter() - t0

    def measure_launched(self, label, by_shape, weighted, launches=50):
        """A kernels-line entry for each (variant, K, M, N) a main path
        launched, with its launches there: the kernel at that shape on
        seeded inputs (the last K // 8 rows shifted by 1000; weighted
        where ``weighted`` or N > 1), timed and held to its plain version
        as ``measure`` does (the plain version's (K, N, chunk)
        temporaries within 512 MB each)."""
        torch = self.torch
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk
        for (variant, k, m, n), launches in sorted(by_shape.items()):
            g = torch.Generator(device=self.dev).manual_seed(k * 7919 + m + n)
            x = torch.randn((k, m), generator=g, device=self.dev)
            x[k - max(1, k // 8):] += 1000.0
            w = weighted or n > 1
            a = location.normalize_weights(torch.rand(
                (k, n), generator=g, device=self.dev) + 0.1) if w \
                else torch.full((k, 1), 1.0 / k, device=self.dev)
            two = variant == "two_pass"
            plan = mk.launch_plan(k, m, n, path="two_pass" if two else
                                  "single", variant=None if two else variant)
            counts = {"single_pass": 0 if two else launches,
                      "two_pass": launches if two else 0}
            by_variant = dict.fromkeys(mk.SINGLE_PASS_VARIANTS, 0)
            if not two:
                by_variant[variant] = launches
            name = "mm_two_pass" if two else "mm_single_pass"
            chunk = max(2 ** 16, 2 ** 27 // (k * n))
            self.measure(f"{name} ({label}, {variant} K={k} M={m} N={n})",
                         f"K={k} M={m} N={n} f32 ({label})", x, a, plan,
                         counts, by_variant, weighted=w, launches=launches,
                         chunk=chunk if m > chunk else None)
            del x, a

    def entry_points(self):
        """The port's examples (repro_torch.examples), each with the gates
        of the module docstring; the sweep's rows go to a temporary
        directory."""
        import tempfile
        self.torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
            self._entry_points(tmp)

    def _entry_points(self, tmp):
        import os
        cuda = ["--device", str(self.dev)]

        def table(out, names):
            rows = {}
            for line in out.splitlines():
                for name in names:
                    if line.startswith(name + " "):
                        rows[name] = [float(v)
                                      for v in line[len(name):].split()]
            return rows

        def report(name, rc, out, counts, by_shape, seconds, **extra):
            emit(dict({"phase": "entry_points", "example": name, "rc": rc,
                       "seconds": seconds, "launches": counts,
                       "by_shape": [list(k) + [v] for k, v in
                                    sorted(by_shape.items())]}, **extra))
            assert rc == 0, (name, rc, out[-2000:])

        # quickstart and federated, as the reference sizes them
        rc, out, counts, by_shape, sec = self._example("quickstart", cuda)
        rows = table(out, ("mean (clean)", "mean (1 attacker)",
                           "REF  (1 attacker)"))
        report("quickstart", rc, out, counts, by_shape, sec, rows=rows)
        assert rows["REF  (1 attacker)"][2] < 1e-2, rows
        assert rows["mean (1 attacker)"][2] > 1.0, rows
        from repro_torch.examples import federated
        rc, out, counts, by_shape, sec = self._example("federated", cuda)
        rows = table(out, tuple(federated.SETTINGS))
        report("federated", rc, out, counts, by_shape, sec, rows=rows)
        assert rows["Robust-FedAvg MM (6/32 malicious)"][1] < 1e-2, rows
        assert rows["FedAvg (6/32 malicious)"][1] > 1.0, rows
        # the sweep's CI preset and the large cohort, on the kernels
        for family in (None, "large_cohort"):
            path = os.path.join(tmp, f"sweep_{family or 'preset'}.json")
            argv = ["--smoke", "--json", path] + cuda + (
                ["--family", family] if family else [])
            rc, out, counts, by_shape, sec = self._example("scenario_sweep",
                                                           argv)
            with open(path) as f:
                sweep = json.load(f)["rows"]
            label = f"scenario_sweep {family or 'preset'}"
            report(label, rc, out, counts, by_shape, sec, rows=[
                {k: r[k] for k in ("name", "steady_msd", "final_msd",
                                   "compile_s", "wall_clock_s", "finite")}
                | {"path": r["launch_audit"]["path"],
                   "variant": r["launch_audit"]["variant"]}
                for r in sweep])
            assert all(r["finite"] and r["device"] == str(self.dev)
                       for r in sweep), sweep
            assert all(r["launch_audit"] for r in sweep
                       if r["backend"] == "pallas"), sweep
            if family:
                assert counts["two_pass"] > 0, counts
                assert sweep[0]["num_agents"] == 1024 and \
                    sweep[0]["launch_audit"]["path"] == "two_pass", sweep[0]
            else:
                assert counts["single_pass"] > 0, counts
            self.measure_launched(label, by_shape, weighted=False)
        # the service on the kernel, clean and under every fault
        for profile in ("clean", "mixed"):
            rc, out, counts, by_shape, sec = self._example(
                "serve_agg", ["--backend", "pallas", "--profile", profile]
                + cuda)
            report(f"serve_agg {profile}", rc, out, counts, by_shape, sec,
                   lines=out.splitlines()[:4])
            assert counts["single_pass"] > 0, counts
            self.measure_launched(f"serve_agg {profile}", by_shape,
                                  weighted=True)
        for arch in ("qwen3-0.6b", "rwkv6-1.6b"):
            rc, out, counts, by_shape, sec = self._example(
                "serve_lm", ["--arch", arch] + cuda)
            report(f"serve_lm {arch}", rc, out, counts, by_shape, sec,
                   lines=out.splitlines()[:2])
            assert out.rstrip().endswith("OK"), out[-500:]
        # three launch.train processes of 8 agents each, the kernel in
        # REF's aggregation (their launches are counted in those
        # processes, not here)
        rc, out, counts, by_shape, sec = self._example(
            "train_robust_lm", ["--steps", str(ENTRY_TRAIN_STEPS)] + cuda)
        losses, run = {}, None
        for line in out.splitlines():
            if line.startswith("=== aggregation="):
                run = ("mean clean", "mean attacked",
                       "REF attacked")[len(losses)]
                losses[run] = []
            elif line.startswith("step ") and run:
                losses[run].append(float(line.split()[3]))
        report("train_robust_lm", rc, out, counts, by_shape, sec,
               losses=losses)
        assert all(math.isfinite(v) for v in losses["REF attacked"]), losses
        assert losses["REF attacked"][-1] < losses["mean attacked"][-1], \
            losses

    # -- the streaming service ---------------------------------------------

    def measure_program(self, key, label, program, rows, launches,
                        plain_err, plain_ms, launches_timed=10):
        """A serve entry of the kernels line: the service's launch
        program (a captured CUDA graph) staged with ``rows`` and timed as
        the other entries time their kernel -- ``ms`` over back-to-back
        replays, ``call_ms`` one replay at a time, ``profiler_ms``
        torch.profiler's device time of a replay -- beside the plain
        check its phase made (``plain_err``, ``plain_ms``) and the
        launches of the service's run (its replays)."""
        plan = program.plan
        k, m = program.k, program.m
        program.stage(rows)
        call_ms, _ = self.not_counted(lambda: self.time_ms(program.replay))
        ms, _ = self.not_counted(
            lambda: self.kernel_ms(program.replay, launches_timed))
        prof, by_name = self.not_counted(lambda: self.profiler_ms(
            program.replay, launches=3 if ms > 10 else 10))
        self.torch.cuda.synchronize()
        program.release()
        if prof is None:
            by_name = {"note": "torch.profiler attributed no device time "
                               "to the graph replay; ms and call_ms are "
                               "CUDA-event times"}
        two = plan.path == "two_pass"
        t, by = bound(plan.total_bytes, mm_ops(
            k, m, 1, True, sort_rows=plan.block_k if two else 0))
        name = "mm_two_pass" if two else "mm_single_pass"
        self.kernels[key] = dict(
            name=key, shape=label, variant=plan.variant or "two_pass",
            launches=launches,
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces="src/repro/kernels/mm_aggregate.py:" +
                     ("306" if two else "243"),
            max_abs_err=plain_err, ms=ms, call_ms=call_ms, profiler_ms=prof,
            profiler_kernels=by_name, plain_ms=plain_ms, bound_ms=t,
            bound_by=by, library_ms=None, block_m=plan.block_m,
            block_k=plan.block_k, n_chunk=plan.n_chunk, graph_replay=True)
        return self.kernels[key]

    def plain_over(self, x, a, est, chunk):
        """(plain ms, max |d|) of the plain version of the kernel the
        launch plan takes, over every column of x (K, M) with weights a
        (K,), ``chunk`` columns at a time, against the estimate ``est``
        (M,)."""
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk
        k, m = x.shape
        aw = location.normalize_weights(a.reshape(k, 1), dtype=self.torch.float32)
        plan = mk.launch_plan(k, m, 1)
        return self.plain_check(x, aw, est.reshape(1, -1), plan, True, chunk)

    def serve(self):
        import dataclasses
        import contextlib
        import io
        from repro_torch.benchmarks import serve_bench
        from repro_torch.kernels import ops
        from repro_torch.serve import CHAOS_PROFILES, ServeConfig, replay
        cfg = ServeConfig(k_min=8, deadline_s=1.0, backend="pallas")

        def run(profile, tenants, chaos):
            return replay(serve_bench.spec_for(profile, SERVE_ROUNDS),
                          chaos=chaos, serve=cfg, rounds=SERVE_ROUNDS, seed=0,
                          tenants=tenants, device="cuda")

        # serve_bench's profiles, as benchmarks/serve_bench.py runs them
        assert SERVE_PROFILES == tuple(
            (p, serve_bench.PROFILE_TENANTS.get(p, 1))
            for p in serve_bench.DEFAULT_PROFILES)
        results = []
        with contextlib.redirect_stdout(io.StringIO()):
            _, counts, variants = self.main_path(lambda: serve_bench.run(
                serve_bench.DEFAULT_PROFILES, rounds=SERVE_ROUNDS,
                device="cuda", results=results))
        rows, replays, captures = [], 0, 0
        for (profile, tenants), res in zip(SERVE_PROFILES, results):
            row = res.to_row()
            tr, c = res.transport, row["counters"]
            fault = "launch_fault" in res.chaos.fault_modes()
            ok = (not row["broke_down"]
                  and row["rounds_completed"] == SERVE_ROUNDS
                  and row["duplicate_admissions"] == 0
                  and all(v > 0 for v in row["recoveries"].values())
                  and tr["exec_cache_compiles"] == tr["exec_cache_keys"]
                  and tr["exec_cache_max_compiles_per_key"] == 1
                  and row["post_warmup_cache_hit"]
                  # a launch that fails other than by injection raises;
                  # what is counted failed exhausted injected faults
                  and c.get("launch_attempts_exhausted", 0)
                  == c.get("launch_failed", 0) * cfg.retry.max_attempts
                  and (fault or c.get("launch_failed", 0) == 0))
            replays += tr["exec_cache_replays"]
            captures += tr["exec_cache_compiles"]
            rows.append({
                "profile": profile, "tenants": tenants, "ok": ok,
                "steady_msd": row["steady_msd"],
                "breakdown_level": row["breakdown_level"],
                "rounds_completed": row["rounds_completed"],
                "duplicate_admissions": row["duplicate_admissions"],
                "recoveries": row["recoveries"],
                "latency_p50": row["latency_p50"],
                "latency_p95": row["latency_p95"],
                "latency_p99": row["latency_p99"],
                "launch_wall_p50": row["launch_wall_p50"],
                "updates_per_sec": row["updates_per_sec"],
                "wall_s": row["wall_s"],
                "exec_cache_keys": tr["exec_cache_keys"],
                "exec_cache_compiles": tr["exec_cache_compiles"],
                "exec_cache_hits": tr["exec_cache_hits"],
                "exec_cache_replays": tr["exec_cache_replays"],
                "launch_failed": c.get("launch_failed", 0),
                "launch_recovered": c.get("launch_recovered", 0),
                "launch_audit": res.launch_audit})
        for row in rows:
            emit(dict(row, phase="serve"))
        assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
        # each replay launches the kernel once, each capture warmed it up
        assert counts == {"single_pass": replays + captures,
                          "two_pass": 0}, (counts, replays, captures)
        assert variants["warp"] == counts["single_pass"], variants
        crash = run("mixed", 2, dataclasses.replace(
            CHAOS_PROFILES["mixed"], crash_restart_frac=(0.5,)))
        assert crash.duplicate_admissions == 0 and \
            crash.crash_restarts == 2, crash.to_row()
        again = [run("mixed", 2, CHAOS_PROFILES["mixed"]) for _ in range(2)]
        same = all(again[0].journals[n].dump() == again[1].journals[n].dump()
                   for n in again[0].journals)
        assert same, "two runs of one replay wrote different journals"
        # the cohort's launch program, timed on a seeded cohort
        engine = ops.get_engine(num_iters=cfg.num_iters, backend=cfg.backend)
        program = self.not_counted(lambda: engine.lower_launch(
            8, 8, self.torch.float32, device="cuda").compile())
        g = self.torch.Generator(device=self.dev).manual_seed(4)
        x = self.torch.randn((8, 8), generator=g, device=self.dev)
        x[7] += 1000.0
        a = self.torch.rand((8,), generator=g, device=self.dev) + 0.5
        est = self.not_counted(lambda: program(x, a)).clone()
        pms, err = self.plain_over(x, a, est, None)
        assert err <= 1e-5 * 1001.0, err
        entry = self.measure_program(
            "mm_single_pass (serve replay)",
            "K=8 M=8 N=1 f32 (serve_bench cohorts, graph replay)", program,
            x, replays, err, pms, launches_timed=50)
        emit({"phase": "serve_replay", "replays": replays,
              "captures": captures, "launches": counts, "variants": variants,
              "crash_duplicate_admissions": crash.duplicate_admissions,
              "crash_restarts": crash.crash_restarts,
              "journals_identical": same, "ms": entry["ms"],
              "call_ms": entry["call_ms"],
              "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "bound_ms": entry["bound_ms"], "plan_variant": program.plan.variant})

    def _serve_cohorts(self, k, m, bad, cohorts, seed, check):
        """A service at k_min = k over width m on the card: ``cohorts``
        full cohorts of k payloads made on the card (the last ``bad``
        shifted by 1000).  ``check(svc, rows)`` runs (uncounted) after
        the first commit, over that cohort's payloads.  Returns (service,
        per-commit rows, launch counts, variants, the last cohort's
        payloads)."""
        torch = self.torch
        from repro_torch.serve import (AgentUpdate, AggregationService,
                                       ServeConfig, SimClock)
        from repro_torch.kernels import launches as tally
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = tally.total("finite_scan")
        svc = AggregationService(
            torch.zeros((m,), device=self.dev),
            config=ServeConfig(k_min=k, deadline_s=1.0, backend="pallas"),
            clock=SimClock(), device="cuda")
        # the initial model's finiteness check: one kernel launch
        assert tally.total("finite_scan") - before == 1, tally.COUNTS
        g = torch.Generator(device=self.dev).manual_seed(seed)
        out, cohort = [], []  # the payloads of the cohort being sent

        def run():
            for c in range(cohorts):
                cohort.clear()  # the last cohort's go once it committed
                for agent in range(k):
                    payload = torch.randn((m,), generator=g, device=self.dev)
                    if agent >= k - bad:
                        payload += 1000.0
                    if agent == k - 1:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    svc.submit(AgentUpdate(agent_id=agent, round=svc.round,
                                           payload=payload, seq=c + 1))
                    cohort.append(payload)
                    del payload
                torch.cuda.synchronize()
                commit_ms = (time.perf_counter() - t0) * 1e3
                (commit,) = svc.drain_commits()
                out.append({"kind": commit.kind, "round": commit.round,
                            "submit_to_commit_ms": commit_ms,
                            "device_ms": svc.phase_ms(),
                            "compile_s": commit.compile_s,
                            "cache_hit": commit.cache_hit,
                            "launch_wall_s": commit.launch_wall_s,
                            "clipped": commit.clipped,
                            "outliers": list(commit.outliers)})
                if c == 0:
                    out[0]["check"] = self.not_counted(
                        lambda: check(svc, cohort))

        _, counts, variants = self.main_path(run)
        return svc, out, counts, variants, cohort

    def _first_commit_check(self, svc, rows, chunk):
        """The first commit's estimate (the model: no trust history yet,
        so no clip) against an eager AggregationEngine.aggregate of the
        same cohort, stacked, and weights (bit for bit) and the plain
        version."""
        torch = self.torch
        from repro_torch.kernels import ops
        x = torch.stack(rows)
        est = svc.model
        a = torch.ones((x.shape[0],), device=self.dev)
        eager = ops.get_engine(num_iters=10, backend="pallas").aggregate(x, a)
        equal = bool(torch.equal(eager, est))
        del eager
        plain_ms, err = self.plain_over(x, a, est, chunk)
        return {"eager_equal": equal, "plain_ms": plain_ms,
                "max_abs_err_all_columns": err}

    def serve_width(self):
        shapes, _ = qwen3_shapes()
        m = sum(math.prod(s) for s in shapes)
        k = WIDTH_AGENTS
        svc, commits, counts, variants, rows = self._serve_cohorts(
            k, m, 1, 3, 5,
            lambda s, r: self._first_commit_check(s, r, 2 ** 24))
        peak = self.torch.cuda.max_memory_allocated()
        check = commits[0].pop("check")
        stats = svc.exec_cache.stats()
        for c in commits:
            emit(dict(c, phase="serve_width"))
        assert [c["kind"] for c in commits] == ["aggregated"] * 3, commits
        assert svc.telemetry.counters["launch_failed"] == 0  # none injected
        assert all(c["outliers"] == [k - 1] for c in commits), commits
        assert (stats["exec_cache_compiles"], stats["exec_cache_hits"],
                stats["exec_cache_replays"]) == (1, 2, 3), stats
        assert svc.telemetry.launch_replays == 3
        assert counts == {"single_pass": 4, "two_pass": 0}, counts
        assert variants["regs"] == 4, variants
        # one finiteness check a submit (admit) and one a commit (guard)
        assert self.finite_launches == 3 * k + 3, self.finite_launches
        # one residual-norm launch a commit: the k members and the model
        assert self.residual_launches == 3, self.residual_launches
        assert check["eager_equal"], check
        assert check["max_abs_err_all_columns"] <= 1e-5 * 1001.0, check
        (program,) = svc.exec_cache.programs()
        entry = self.measure_program(
            "mm_single_pass (serve, Qwen3-0.6B width)",
            f"K={k} M={m} N=1 f32 (service, graph replay)", program, rows,
            stats["exec_cache_replays"], check["max_abs_err_all_columns"],
            check["plain_ms"])
        finite = self.measure_finite(
            "finite_scan (serve, Qwen3-0.6B width)",
            f"f32 {m} (one payload of the service)", rows[0],
            self.finite_launches)
        est = svc.model
        residual = self.measure_residual(
            "residual_norms (serve, Qwen3-0.6B width)",
            f"{k + 1} x {m} (the cohort and the model)",
            [*rows, est], est, self.residual_launches)
        emit({"phase": "serve_width", "m": m, "k": k, "stats": stats,
              "launches": counts, "finite_launches": self.finite_launches,
              "residual_launches": self.residual_launches,
              "residual_ms": residual["ms"],
              "residual_profiler_ms": residual["profiler_ms"],
              "finite_ms": finite["ms"],
              "finite_profiler_ms": finite["profiler_ms"],
              "variant": program.plan.variant,
              "eager_equal": check["eager_equal"],
              "max_abs_err_all_columns": check["max_abs_err_all_columns"],
              "ms": entry["ms"], "call_ms": entry["call_ms"],
              "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
              "bound_by": entry["bound_by"],
              "compile_s": commits[0]["compile_s"],
              "max_memory_allocated": peak})
        del svc, program, est, rows

    def serve_cohort(self):
        m, k, bad = layer_width(), SERVE_COHORT_K, SERVE_COHORT_BAD
        svc, commits, counts, variants, rows = self._serve_cohorts(
            k, m, bad, 2, 6,
            lambda s, r: self._first_commit_check(s, r, 2 ** 20))
        peak = self.torch.cuda.max_memory_allocated()
        check = commits[0].pop("check")
        stats = svc.exec_cache.stats()
        for c in commits:
            emit(dict(c, phase="serve_cohort"))
        assert [c["kind"] for c in commits] == ["aggregated"] * 2, commits
        assert svc.telemetry.counters["launch_failed"] == 0  # none injected
        assert all(c["outliers"] == list(range(k - bad, k))
                   for c in commits), commits
        assert (stats["exec_cache_compiles"],
                stats["exec_cache_replays"]) == (1, 2), stats
        assert counts == {"single_pass": 0, "two_pass": 3}, counts
        # one finiteness check a submit (admit) and one a commit (guard)
        assert self.finite_launches == 2 * k + 2, self.finite_launches
        # one residual-norm launch a commit: the k members and the model
        assert self.residual_launches == 2, self.residual_launches
        assert check["eager_equal"], check
        assert check["max_abs_err_all_columns"] <= 1e-5 * 1001.0, check
        (program,) = svc.exec_cache.programs()
        assert program.plan.path == "two_pass", program.plan
        assert program.plan.num_k_blocks == 1, program.plan
        # the launch is the group layout's: the C entry point names it
        from repro_torch.kernels import mm_aggregate as mk
        bk = program.plan.block_k
        kernel = mk.launch_query(mk.kernel_call(
            program.plan, k=k, m=m))["instantiation"]
        assert kernel == (f"mm_two_pass<{mk.two_pass_rows(bk)}, true, float, "
                          f"{mk.two_pass_lanes(bk)}>"), kernel
        entry = self.measure_program(
            "mm_two_pass (serve, 128-client cohort layer)",
            f"K={k} M={m} N=1 f32 (service, graph replay)", program, rows,
            stats["exec_cache_replays"], check["max_abs_err_all_columns"],
            check["plain_ms"])
        finite = self.measure_finite(
            "finite_scan (serve, 128-client cohort layer)",
            f"f32 {m} (one payload of the service)", rows[0],
            self.finite_launches)
        est = svc.model
        residual = self.measure_residual(
            "residual_norms (serve, 128-client cohort layer)",
            f"{k + 1} x {m} (the cohort and the model)",
            [*rows, est], est, self.residual_launches)
        emit({"phase": "serve_cohort", "m": m, "k": k, "stats": stats,
              "launches": counts, "finite_launches": self.finite_launches,
              "residual_launches": self.residual_launches,
              "residual_ms": residual["ms"],
              "residual_profiler_ms": residual["profiler_ms"],
              "finite_ms": finite["ms"],
              "finite_profiler_ms": finite["profiler_ms"],
              "path": program.plan.path, "kernel": kernel,
              "block_m": program.plan.block_m,
              "block_k": program.plan.block_k,
              "num_k_blocks": program.plan.num_k_blocks,
              "smem_bytes": program.plan.smem_bytes,
              "eager_equal": check["eager_equal"],
              "max_abs_err_all_columns": check["max_abs_err_all_columns"],
              "ms": entry["ms"], "call_ms": entry["call_ms"],
              "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
              "bound_by": entry["bound_by"],
              "compile_s": commits[0]["compile_s"],
              "max_memory_allocated": peak})
        del svc, program, est, rows

    # -- the LM substrate --------------------------------------------------

    def _lm_model(self, cfg, seed, params, leaves):
        """The phase's model, randomly initialised on the card: its
        parameter and leaf counts; Qwen3-0.6B's shape besides."""
        from repro_torch.models import model as M
        if cfg.name == "qwen3-0.6b":
            assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                    cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
                    cfg.padded_vocab, cfg.act_dtype) == (
                        28, 1024, 16, 8, 128, 3072, 151_936, 152_064,
                        "bfloat16"), cfg
        model = M.init_model(cfg, seed=seed, device="cuda")
        got = list(model.parameters())
        assert len(got) == leaves and sum(p.numel() for p in got) == params, \
            (cfg.name, len(got), sum(p.numel() for p in got))
        return model

    def _lm_gates(self, step, names, delta=1000.0):
        """Gates (a) and (b) on the step's stacks and estimates, leaf by
        leaf: the estimate against the plain version on the same stack,
        and against the benign agents' mean (agent K-1 attacks), whose
        all-agent mean moves by about delta / K; and every agent's
        gradient finite in every leaf."""
        torch = self.torch
        from repro_torch.kernels import mm_aggregate as mk
        rows = []
        for name, x, est in zip(names, step.last_stacks, step.last_aggregate):
            k = x.shape[0]
            x2, e2 = x.reshape(k, -1), est.reshape(1, -1)
            m = x2.shape[1]
            plan = mk.launch_plan(k, m, 1)
            uniform = torch.full((k, 1), 1.0 / k, device=self.dev)
            plain_ms, err = self.plain_check(x2, uniform, e2, plan, False,
                                             chunk=2 ** 24)
            benign_mean = x2[:k - 1].mean(0)
            est_max = float(e2.abs().max())
            # the leaf's typical |estimate|, beside the tolerance it meets
            rms = float(e2.double().square().mean().sqrt())
            rows.append({
                "leaf": name, "m": m, "variant": plan.variant,
                "max_abs_err": err, "est_max": est_max, "est_rms": rms,
                "tol": 1e-5 * max(1.0, est_max),
                # the same 1e-5 of the leaf's own largest |estimate|: the
                # gradients are 1e-4 to 1e-1, where the floor of 1 would
                # let an error as large as a typical value pass
                "tol_leaf": 1e-5 * est_max,
                "err_over_rms": err / rms if rms else None,
                "plain_ms": plain_ms,
                "max_dev_from_benign_mean": float(
                    (e2[0] - benign_mean).abs().max()),
                "min_mean_shift": float(
                    (x2.mean(0) - benign_mean).abs().min()),
                "expected_shift": delta / k,
                "stack_finite": bool(torch.isfinite(x2).all())})
            del benign_mean
        return rows

    def _lm_batches(self, cfg, args):
        """launch.train's batches for the phase's steps: the token stream
        and, for the encoder-decoder, the stub frames."""
        torch = self.torch
        from repro_torch.data import synthetic
        from repro_torch.models import model as M
        stream = synthetic.token_batches(synthetic.TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq,
            batch_size=args.batch, seed=0))
        frames_gen = torch.Generator(device=self.dev).manual_seed(1)
        batches = []
        for _ in range(args.steps):
            batch = {"tokens": torch.from_numpy(next(stream)["tokens"])
                     .to(self.dev)}
            if cfg.arch_type == "audio":
                batch["frames"] = synthetic.make_frames(
                    frames_gen, args.batch, cfg.num_prefix_tokens,
                    cfg.d_model, M.act_dtype(cfg), self.dev)
            batches.append(batch)
        return batches

    def lm_train_run(self, phase):
        """One train phase of LM_TRAIN_RUNS: its model at full width
        trained by the Mode A step launch.train builds, gated leaf by
        leaf, each distinct (K, M, 1) leaf shape a kernels-line entry."""
        torch = self.torch
        from repro_torch import configs, pytree
        from repro_torch.kernels import launches as tally
        from repro_torch.kernels import mm_aggregate as mk
        from repro_torch.launch import train
        from repro_torch.models import model as M
        from repro_torch.optim import optimizers
        run = LM_TRAIN_RUNS[phase]
        torch.cuda.empty_cache()
        args = train.parser().parse_args(list(run["args"]))
        cfg, par, opt_cfg, step = train.build(args, consensus_metric=True)
        full = configs.load_arch(args.arch).model
        assert cfg == dataclasses.replace(
            full, num_layers=args.layers or full.num_layers), cfg
        k = args.agents
        assert par.remat and par.use_kernel and opt_cfg.name == "adam" \
            and opt_cfg.grad_clip == 1.0, (par, opt_cfg)
        torch.cuda.reset_peak_memory_stats()
        model = self._lm_model(cfg, 0, run["params"], run["leaves"])
        names = pytree.leaf_paths(model.tree())
        state = {"opt": optimizers.init(opt_cfg, model.tree())}
        batches = self._lm_batches(cfg, args)
        rows, gates = [], []

        def run_steps():
            for i, batch in enumerate(batches):
                before = tally.COUNTS.copy()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                _, state["opt"], m = step(model, state["opt"], batch)
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
                step_peak = torch.cuda.max_memory_allocated()
                launches, variants, by_shape = self._tally(
                    tally.COUNTS - before)
                rows.append({"phase": phase, "step": i + 1,
                             "host_ms": host_ms, "device_ms": step.phase_ms(),
                             "loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "consensus": float(m["consensus"]),
                             "stacks_finite": all(
                                 bool(torch.isfinite(s).all())
                                 for s in step.last_stacks),
                             "max_memory_allocated": step_peak,
                             "launches": launches, "variants": variants,
                             "by_shape": by_shape})
                if i == 0:
                    gates.extend(self.not_counted(
                        lambda: self._lm_gates(step, names, args.delta)))

        _, counts, variants = self.main_path(run_steps)
        by_shape = self.by_shape
        # the card's busy share over one more step (CUDA tracing only, so
        # the profiler adds little host time to the step it watches)
        busy = self.not_counted(lambda: self.device_busy_share(
            lambda: step(model, state["opt"], batches[-1]), cpu=False))
        for row in rows:
            emit(dict(row, by_shape={str(key): n for key, n
                                     in row["by_shape"].items()}))
        for g in gates:
            emit(dict(g, phase=f"{phase}_leaf"))
        n_leaves = len(names)
        # each leaf's (K, M, N) and the variant its plan takes: every step
        # must launch that kernel once for each leaf of that shape
        per_step: dict = {}
        for g in gates:
            key = (g["variant"], k, g["m"], 1)
            per_step[key] = per_step.get(key, 0) + 1
        for row in rows:
            assert row["launches"] == {"single_pass": n_leaves,
                                       "two_pass": 0}, row
            if "variants" in run:   # Qwen3: 11 regs, 3 warp
                assert all(row["variants"][v] == n for v, n
                           in run["variants"].items()), row
            assert row["by_shape"] == per_step, (row["by_shape"], per_step)
            assert all(math.isfinite(row[key])
                       for key in ("loss", "grad_norm", "consensus")), row
            assert row["stacks_finite"], row
        assert all(g["stack_finite"] for g in gates), gates
        assert all(g["max_abs_err"] <= g["tol"] for g in gates), gates
        assert all(g["max_abs_err"] <= g["tol_leaf"] for g in gates), gates
        assert all(g["max_dev_from_benign_mean"] < 1.0 for g in gates), gates
        assert all(g["min_mean_shift"] >= 0.9 * g["expected_shift"]
                   for g in gates), gates
        ln_v = math.log(cfg.vocab_size)
        assert abs(rows[0]["loss"] - ln_v) <= 1.5, (rows[0]["loss"], ln_v)
        # one kernels-line entry per distinct (K, M, 1) leaf shape, timed
        # on the last step's stacks
        shapes: dict = {}
        for i, g in enumerate(gates):
            shapes.setdefault(g["m"], []).append(i)
        uniform = torch.full((k, 1), 1.0 / k, device=self.dev)
        assert by_shape == {key: n * args.steps
                            for key, n in per_step.items()}, by_shape
        for m, ix in shapes.items():
            x = step.last_stacks[ix[0]].reshape(k, -1)
            plan = mk.launch_plan(k, m, 1)
            call = lambda: mk.single_pass(x, uniform, plan, weighted=False)
            call_ms, _ = self.not_counted(lambda: self.time_ms(call))
            ms, _ = self.not_counted(lambda: self.kernel_ms(call))
            prof, by_name = self.not_counted(lambda: self.profiler_ms(call))
            t, by = bound(plan.total_bytes, mm_ops(k, m, 1, False))
            leaves = ", ".join(gates[i]["leaf"] for i in ix)
            key = f"mm_single_pass ({run['label']} train step: {leaves})"
            self.kernels[key] = dict(
                name=key, shape=f"K={k} M={m} N=1 f32 ({leaves})",
                variant=plan.variant,
                launches=by_shape[(plan.variant, k, m, 1)],
                source="src/repro_torch/kernels/csrc/mm_single_pass.cu",
                replaces="src/repro/kernels/mm_aggregate.py:243",
                max_abs_err=max(gates[i]["max_abs_err"] for i in ix),
                ms=ms, call_ms=call_ms, profiler_ms=prof,
                profiler_kernels=by_name,
                plain_ms=gates[ix[0]]["plain_ms"], bound_ms=t, bound_by=by,
                library_ms=None, block_m=plan.block_m)
        assert sum(e["launches"] for e in self.kernels.values()
                   if f"{run['label']} train step" in e["name"]) == \
            counts["single_pass"]
        extra = {}
        if run.get("host_profile"):
            # the host's time by operator over one agent's forward and
            # backward, the code TrainStep runs for each agent and nearly
            # all of a step's host time.  A whole step traced took 77 s
            # to summarize its ~10^6 host events, and its window emptied
            # six of the seven CUDA-only windows after it; this one comes
            # after them
            def one_agent():
                leaves = list(model.parameters())
                loss = M.loss_fn(model.tree(), cfg,
                                 {"tokens": batches[-1]["tokens"][:1]},
                                 remat=par.remat)
                torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
            extra["host_profile"] = self.host_profile(one_agent)
        emit(dict({"phase": phase, "arch": cfg.name,
                   "layers": cfg.num_layers, "params": run["params"],
                   "leaves": n_leaves, "agents": k, "seq_len": args.seq,
                   "steps": args.steps, "launches": counts,
                   "variants": variants, "ln_vocab": ln_v,
                   "device_busy_share": busy, "host": host_info(),
                   "kernels_per_step": self.busy_kernels,
                   "top_kernels_ms": self.busy_top,
                   "max_memory_allocated": max(r["max_memory_allocated"]
                                               for r in rows),
                   "gate_a_max_err_over_tol": max(g["max_abs_err"] / g["tol"]
                                                  for g in gates),
                   "gate_a_max_err_over_leaf_tol": max(
                       g["max_abs_err"] / g["tol_leaf"] for g in gates),
                   "gate_a_max_err_over_rms": max(g["err_over_rms"] or 0.0
                                                  for g in gates),
                   "gate_b_max_dev": max(g["max_dev_from_benign_mean"]
                                         for g in gates),
                   "min_mean_shift": min(g["min_mean_shift"]
                                         for g in gates)}, **extra))
        step.last_stacks = step.last_aggregate = None
        del model, state, step

    def _cross_cache(self, model, cfg, frames, cache):
        """The encoder-decoder's cross cache, projected by hand from the
        encoder output as the reference's test fills it (no prefill of
        either package fills it)."""
        torch = self.torch
        from repro_torch.models import layers as L
        from repro_torch.models import model as M
        tree = model.tree()
        with torch.no_grad():
            enc = M._encdec_encode(tree, cfg, frames, M._id_hook, False)
            xdims = M.attn_dims(cfg, causal=False)
            kv = [L.project_enc_kv({n: t[i] for n, t in
                                    tree["blocks"]["xattn"].items()},
                                   enc, xdims)
                  for i in range(cfg.num_layers)]
        cache["cross"] = {"k": torch.stack([k for k, _ in kv]),
                          "v": torch.stack([v for _, v in kv])}
        return cache

    def lm_serve_run(self, phase):
        """One serve phase of LM_SERVE_RUNS: make_prefill_step and
        make_decode_step on the full config at batch 4, the decode held
        to the full-sequence forward."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.data import synthetic
        from repro_torch.launch import steps
        from repro_torch.models import model as M
        run = LM_SERVE_RUNS[phase]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = configs.load_arch(run["arch"]).model
        model = self._lm_model(cfg, 1, run["params"], run["leaves"])
        b, plen, ntok = LM_SERVE_BATCH, LM_SERVE_PROMPT, LM_SERVE_TOKENS
        teacher = run["teacher"]
        v = cfg.vocab_size
        g = torch.Generator(device=self.dev).manual_seed(7)
        prompt = torch.randint(0, v, (b, plen), generator=g, device=self.dev,
                               dtype=torch.int32)
        batch = {"tokens": prompt}
        if cfg.arch_type == "audio":
            batch["frames"] = synthetic.make_frames(
                g, b, cfg.num_prefix_tokens, cfg.d_model, M.act_dtype(cfg),
                self.dev)
        prefill = steps.make_prefill_step(cfg, "cuda")
        decode = steps.make_decode_step(cfg, "cuda")
        prefill_ms, last = self.time_ms(lambda: prefill(model, batch))
        with torch.no_grad():
            full, _ = M.forward(model, cfg, batch, remat=False)
        want = full[:, :LM_SERVE_CHECKED, :v].float()
        del full
        tol = LM_SERVE_TOL * max(1.0, float(want.abs().max()))
        f32 = {}
        if run.get("f32_check"):
            f32 = self._f32_decode_check(model, cfg, batch)
            floor = float((want - f32.pop("want")).abs().max())
            f32["bf16_forward_vs_f32_max_err"] = floor
            tol = max(tol, 2.0 * floor)
        cache = M.init_cache(cfg, b, teacher + ntok, device="cuda")
        if cfg.arch_type == "audio":
            cache = self._cross_cache(model, cfg, batch["frames"], cache)
        errs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(teacher):
                tok = prompt[:, t:t + 1]
                if t < LM_SERVE_CHECKED or t == teacher - 1:
                    logits, cache = M.decode_step(model, cfg, tok, cache)
                    if t < LM_SERVE_CHECKED:
                        errs.append(float((logits[:, 0, :v].float()
                                           - want[:, t]).abs().max()))
                else:
                    _, cache = decode(model, tok, cache)
        torch.cuda.synchronize()
        fill_ms = (time.perf_counter() - t0) * 1e3
        last_err = None
        if teacher == plen:     # the whole prompt: its last position too
            last_err = float((logits[:, 0, :v].float()
                              - last[:, 0, :v].float()).abs().max())
        out = [torch.argmax(logits, dim=-1).to(torch.int32)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ntok - 1):
            nxt, cache = decode(model, out[-1], cache)
            out.append(nxt)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (ntok - 1)
        gen = torch.cat(out, dim=1)
        busy = self.device_busy_share(
            lambda: decode(model, out[-1], cache), cpu=False)
        peak = torch.cuda.max_memory_allocated()
        # the attention caches' next position, where the family has one
        pos = cache["attn"]["pos"] if cfg.arch_type == "hybrid" else \
            cache["blocks"].get("pos")
        emit({"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
              "batch": b, "prompt": plen, "teacher_forced": teacher,
              "generated": ntok, "prefill_ms": prefill_ms,
              "prompt_through_decode_ms": fill_ms,
              "decode_ms_per_token": decode_ms,
              "decode_device_busy_share": busy,
              "decode_kernels_per_token": self.busy_kernels,
              "decode_top_kernels_ms": self.busy_top,
              "decode_vs_forward_max_err": errs, "tol": tol, **f32,
              "last_position_vs_prefill_err": last_err,
              "cache_pos": None if pos is None else int(pos.max()),
              "generated_head": gen[0, :8].tolist(),
              "max_memory_allocated": peak})
        assert gen.shape == (b, ntok) and int(gen.max()) < v, gen
        if pos is not None:
            assert int(pos.min()) == teacher + ntok - 1, pos
        assert max(errs) <= tol, (errs, tol)
        assert last_err is None or last_err <= tol, (last_err, tol)
        if f32:
            assert max(f32["f32_decode_vs_forward_max_err"]) <= \
                f32["f32_tol"], f32
        del model, cache

    def _f32_decode_check(self, model, cfg, batch) -> dict:
        """The same weights and prompt with f32 activations: the forward's
        logits on the checked positions (``want``), how far the bf16
        forward's arithmetic alone moves them (the caller's floor), and
        the f32 decode of those positions against the f32 forward."""
        torch = self.torch
        from repro_torch.models import model as M
        cfg32 = dataclasses.replace(cfg, act_dtype="float32")
        n, v = LM_SERVE_CHECKED, cfg.vocab_size
        with torch.no_grad():
            full, _ = M.forward(model, cfg32, batch, remat=False)
            want = full[:, :n, :v].float()
            del full
            cache = M.init_cache(cfg32, batch["tokens"].shape[0], n,
                                 device="cuda")
            if cfg.arch_type == "audio":
                cache = self._cross_cache(model, cfg32, batch["frames"], cache)
            errs = []
            for t in range(n):
                logits, cache = M.decode_step(
                    model, cfg32, batch["tokens"][:, t:t + 1], cache)
                errs.append(float((logits[:, 0, :v] - want[:, t])
                                  .abs().max()))
        return {"want": want, "f32_decode_vs_forward_max_err": errs,
                "f32_tol": LM_SERVE_F32_TOL * max(1.0,
                                                  float(want.abs().max()))}

    # -- the collectives and Mode B: DIST_K agent processes on the card -----

    def _spawn(self, fn, *args, pods: int = 1):
        """fn on DIST_K ranks sharing the card over gloo, after the
        kernels are built here (so no rank runs nvcc); any failing rank
        fails the phase with its traceback."""
        from repro_torch.kernels import build
        from repro_torch.launch import mesh as mesh_lib
        build.load_all()
        self.torch.cuda.synchronize()
        self.torch.cuda.empty_cache()
        return mesh_lib.run_ranks(fn, DIST_K, *args, pods=pods, cuda=True,
                                  timeout_s=DIST_TIMEOUT_S)

    def _dist_entries(self, phase, label, ranks):
        """One kernels-line entry per (K, M) that rank 0 timed: launches
        are every rank's count of that shape over the main path."""
        for row in ranks[0]["timing"]:
            key = str((row["variant"], row["k"], row["m"], 1))
            launches = sum(rk["by_shape"].get(key, 0) for rk in ranks)
            assert launches > 0, (phase, key)
            self.kernel_shapes.add((row["variant"], row["k"], row["m"], 1))
            assert row["max_abs_err"] <= row["tol"], (phase, row)
            name = f"mm_single_pass ({label}: K={row['k']} M={row['m']})"
            self.kernels[name] = dict(
                name=name, shape=f"K={row['k']} M={row['m']} N=1 f32, "
                f"local block of one of {DIST_K} ranks", launches=launches,
                launches_per_rank=[rk["by_shape"].get(key, 0) for rk in ranks],
                source="src/repro_torch/kernels/csrc/mm_single_pass.cu",
                replaces="src/repro/kernels/mm_aggregate.py:243",
                **{f: row[f] for f in ("variant", "max_abs_err", "ms",
                                       "call_ms", "profiler_ms",
                                       "profiler_kernels", "plain_ms",
                                       "bound_ms", "bound_by", "block_m")},
                library_ms=None)

    def sharded(self):
        """DIST_K agent processes, each with its own update shaped like
        Qwen3-0.6B's tree, through robust_all_reduce_tree (rs_mm, then
        mean) on the kernel; the gates of each rank."""
        ranks = self._spawn(_sharded_rank, 0, pods=DIST_PODS)
        shapes, _ = qwen3_shapes()
        ms_by_m = {row["m"]: row["ms"] for row in ranks[0]["timing"]}
        for rk in ranks:
            for method, run in rk["collectives"].items():
                kernel_ms = sum(ms_by_m[g["m"]] for g in rk["gates"]) \
                    if method != "mean" else 0.0
                emit({"phase": "sharded", "rank": rk["rank"],
                      "collective": f"robust_all_reduce_tree {method}",
                      "host_ms": run["host_ms"],
                      "kernel_ms_rank0_timing": kernel_ms,
                      "sent_bytes": run["sent"],
                      "transport": rk["transport"]})
            emit(dict({"phase": "sharded_layer", "rank": rk["rank"]},
                      **rk["layer"]))
            emit(dict({"phase": "sharded_probe", "rank": rk["rank"],
                       "transport": rk["transport"]}, **rk["probe"]))
        for g in ranks[0]["gates"]:
            emit(dict(g, phase="sharded_leaf", rank=0))
        for rk in ranks:
            assert rk["launches"] == {"single_pass": len(shapes),
                                      "two_pass": 0}, rk["launches"]
            assert rk["transport"] == "gloo:direct", rk["transport"]
            assert all(g["finite"] and g["max_abs_err"] <= g["tol"]
                       for g in rk["gates"]), rk["gates"]
            lay = rk["layer"]
            assert lay["rs_vs_gather_max_err"] <= lay["tol"], lay
            if lay["rs_mm_variant"] == lay["gather_mm_variant"]:
                assert lay["rs_equals_gather"], lay
            assert lay["hier_vs_pod_mean_max_err"] <= lay["hier_tol"], lay
            for method in ("rs_mm", "mean"):
                assert rk["checksums"][method] == \
                    ranks[0]["checksums"][method], (method, rk["rank"])
        self._dist_entries("sharded", "robust_all_reduce_tree rs_mm over "
                           "Qwen3-0.6B's tree", ranks)
        emit({"phase": "sharded", "ranks": DIST_K, "pods": DIST_PODS,
              "backend_transport": ranks[0]["transport"],
              "launches_per_rank": [rk["launches"] for rk in ranks],
              "variants_per_rank": [rk["variants"] for rk in ranks],
              "checksums_equal_across_ranks": True,
              "max_memory_allocated_per_rank": [
                  rk["max_memory_allocated"] for rk in ranks],
              "gate_a_max_err_over_tol": max(
                  g["max_abs_err"] / g["tol"] for rk in ranks
                  for g in rk["gates"])})

    def _fsdp_mode_a(self, cfg, tokens):
        """Mode A's SGD step (lr 1, no clip) on the same seeded model and
        batches: its update p0 - p1, the benign agents' mean gradient and
        the all-agent mean's least shift from it, per leaf, on the host."""
        torch = self.torch
        from repro_torch import configs, pytree
        from repro_torch.core import attacks
        from repro_torch.launch import steps
        from repro_torch.optim import optimizers
        k = DIST_K
        model = self._lm_model(cfg, 0, QWEN3_0P6B_PARAMS, 14)
        sgd = optimizers.OptimizerConfig(**FSDP_SGD)
        step = steps.make_train_step_gspmd(
            cfg, configs.ParallelConfig(aggregation="rs_mm", use_kernel=True,
                                        remat=True, microbatches=1),
            sgd, "cuda", attacks.ByzantineConfig(
                num_malicious=1, attack="additive",
                attack_kwargs=(("delta", DIST_DELTA),)), k_agents=k)
        leaves = pytree.flatten(model.tree())[0]
        p0 = [t.detach().clone() for t in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step(model, optimizers.init(sgd, model.tree()),
                       {"tokens": tokens})
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        out = {"update": [], "benign": [], "shift": []}
        with torch.no_grad():
            for a, b, s in zip(p0, leaves, step.last_stacks):
                out["update"].append((a - b).cpu())
                benign = s[:k - 1].mean(0)
                out["benign"].append(benign.cpu())
                out["shift"].append(float((s.mean(0) - benign).abs().min()))
        step.last_stacks = step.last_aggregate = None
        del model, p0, leaves, step
        torch.cuda.empty_cache()
        return out, {"mode_a_host_ms": host_ms, "mode_a_loss": float(m["loss"])}

    def fsdp_train(self):
        """Mode B on full-size Qwen3-0.6B over DIST_K agent processes:
        Mode A's update first (here, kept on the host), then the ranks."""
        import os
        import shutil
        import tempfile
        torch = self.torch
        from repro_torch import configs
        cfg = configs.load_arch("qwen3-0.6b").model
        g = torch.Generator(device=self.dev).manual_seed(11)
        tokens = torch.randint(0, cfg.vocab_size, (DIST_K, 1025), generator=g,
                               device=self.dev, dtype=torch.int32)
        t0 = time.perf_counter()
        ref, mode_a = self.not_counted(lambda: self._fsdp_mode_a(cfg, tokens))
        mode_a["mode_a_s"] = time.perf_counter() - t0
        tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
        try:
            path = os.path.join(tmp, "mode_a.pt")
            t0 = time.perf_counter()
            torch.save(ref, path)
            mode_a["mode_a_save_s"] = time.perf_counter() - t0
            del ref
            t0 = time.perf_counter()
            ranks = self._spawn(_fsdp_train_rank, path, tokens.cpu().numpy())
            mode_a["ranks_s"] = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for rk in ranks:
            for row in rk["rows"]:
                emit(dict(row, phase="fsdp_train"))
        for rk in ranks:
            for g in rk["gates"]:
                emit(dict(g, phase="fsdp_train_leaf"))
        ln_v = math.log(cfg.vocab_size)
        hooked = sum(1 for g in ranks[0]["gates"] if g["fsdp_dim"] >= 0)
        per_step = cfg.num_layers * hooked + (len(ranks[0]["gates"]) - hooked)
        for rk in ranks:
            for row in rk["rows"]:
                assert row["launches"] == {"single_pass": per_step,
                                           "two_pass": 0}, row
                assert math.isfinite(row["loss"]) and \
                    math.isfinite(row["grad_norm"]), row
            assert abs(rk["rows"][0]["loss"] - ln_v) <= 1.5, rk["rows"][0]
            for g in rk["gates"]:
                assert g["finite"], g
                assert g["off"] <= max(2, g["size"] // 100), g       # (a)
                assert g["max_err"] <= g["tol_max"], g
                assert g["max_dev_from_benign_mean"] < 1.0, g         # (b)
                assert g["min_mean_shift"] >= 0.9 * DIST_DELTA / DIST_K, g
        self._dist_entries("fsdp_train", "Qwen3-0.6B Mode B step", ranks)
        self.fsdp_traffic = [row["traffic"] for rk in ranks
                             for row in rk["rows"]]
        emit(dict({"phase": "fsdp_train", "arch": cfg.name, "ranks": DIST_K,
                   "seq_len": 1024, "steps": 1 + FSDP_TRAIN_STEPS,
                   "launches_per_step_per_rank": per_step,
                   "transport": ranks[0]["transport"],
                   "launches_per_rank": [rk["launches"] for rk in ranks],
                   "variants_per_rank": [rk["variants"] for rk in ranks],
                   "ln_vocab": ln_v,
                   "gate_a_max_err_over_tol": max(
                       g["max_err"] / g["tol_max"] for rk in ranks
                       for g in rk["gates"] if g["tol_max"]),
                   "gate_a_max_off_share": max(
                       g["off"] / g["size"] for rk in ranks
                       for g in rk["gates"]),
                   "gate_b_max_dev": max(g["max_dev_from_benign_mean"]
                                         for rk in ranks for g in rk["gates"]),
                   "min_mean_shift": min(g["min_mean_shift"]
                                         for g in ranks[0]["gates"]),
                   "drift_after_adam": {rk["rank"]: rk["drift"]
                                        for rk in ranks},
                   "max_memory_allocated_per_rank": [
                       max(row["max_memory_allocated"] for row in rk["rows"])
                       for rk in ranks]}, **mode_a))

    def _fsdp_serve_reference(self, cfg, prompt):
        """Mode A's unsharded prefill, and greedy decode from the prompt's
        first token: its logits at the checked positions and its tokens."""
        torch = self.torch
        from repro_torch.launch import steps
        from repro_torch.models import model as M
        v = cfg.vocab_size
        model = self._lm_model(cfg, 1, QWEN3_0P6B_PARAMS, 14)
        last = steps.make_prefill_step(cfg, "cuda")(model, {"tokens": prompt})
        cache = M.init_cache(cfg, prompt.shape[0], LM_SERVE_TOKENS,
                             device="cuda")
        tok, logits_at, toks = prompt[:, :1], [], []
        with torch.no_grad():
            for t in range(LM_SERVE_TOKENS):
                logits, cache = M.decode_step(model, cfg, tok, cache)
                if t < FSDP_SERVE_CHECKED:
                    logits_at.append(logits[:, 0, :v].float().cpu())
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(tok.cpu())
        out = {"prefill": last[:, 0, :v].float().cpu(),
               "logits": torch.stack(logits_at, dim=1),
               "tokens": torch.cat(toks, dim=1)}
        del model, cache
        torch.cuda.empty_cache()
        return out

    def fsdp_serve(self):
        """The FSDP prefill and decode steps on full-size Qwen3-0.6B over
        DIST_K agent processes, one row of the batch each, held to Mode
        A's unsharded steps on the same parameters."""
        import os
        import shutil
        import tempfile
        torch = self.torch
        from repro_torch import configs
        cfg = configs.load_arch("qwen3-0.6b").model
        g = torch.Generator(device=self.dev).manual_seed(7)
        prompt = torch.randint(0, cfg.vocab_size, (DIST_K, LM_SERVE_PROMPT),
                               generator=g, device=self.dev,
                               dtype=torch.int32)
        ref = self._fsdp_serve_reference(cfg, prompt)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_serve_")
        try:
            path = os.path.join(tmp, "mode_a.pt")
            torch.save(ref, path)
            ranks = self._spawn(_fsdp_serve_rank, path, prompt.cpu().numpy())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for rk in ranks:
            emit(dict(rk, phase="fsdp_serve", batch=DIST_K,
                      prompt=LM_SERVE_PROMPT, generated=FSDP_SERVE_TOKENS))
        for rk in ranks:
            assert rk["prefill_max_err"] <= rk["tol"], rk
            assert max(rk["decode_vs_mode_a_max_err"]) <= rk["tol"], rk
            assert all(t < rk["vocab"] for t in rk["generated_head"]), rk

    def dryrun(self):
        """The dry run (repro_torch.launch.dryrun) on the card's host: the
        matrix's DRYRUN_PAIRS traced on meta tensors (the pairs left out
        named on a line first), then held to the card: a full-size
        Qwen3-0.6B Mode A step (K = 8 agents of one 1024-token sequence,
        as lm_train) run on the card and traced on meta, whose MM
        launches by (variant, K, M, N), flops and argument bytes (the
        allocator's requested bytes; memory_allocated against the bytes
        rounded to its 512-byte blocks) must be equal; and Mode B at fsdp_train's shape on a 4-rank group that
        moves nothing, whose bytes sent by kind must equal what each rank
        of fsdp_train sent in each step.  The predicted peak memory is
        printed beside the measured one (reported, not gated)."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.configs.base import InputShape
        from repro_torch.kernels import launches as tally
        from repro_torch.launch import dryrun as D
        from repro_torch.optim import optimizers
        left = [p for p in D.pairs() if p not in DRYRUN_PAIRS]
        emit({"phase": "dryrun_left_out", "pairs": left,
              "why": DRYRUN_LEFT_OUT_WHY})
        t0 = time.perf_counter()
        traced, matrix_s = self.dryrun_matrix.get(
            timeout=DRYRUN_MATRIX_TIMEOUT_S)
        matrix_wait_s = time.perf_counter() - t0
        for (arch, shape), rec, err in traced:
            assert err is None, (arch, shape, err)
            # the bench phase's roofline reads them
            D.write_record(str(DRYRUN_DIR), rec)
            self.dryrun_records += 1
            mem = rec["memory"]
            emit({"phase": "dryrun_pair", "arch": arch, "shape": shape,
                  "mode": rec["mode"], "trace_s": rec["trace_s"],
                  "params": rec["params"], "param_numel": rec["param_numel"],
                  "argument_bytes": mem["argument_bytes"],
                  "saved_for_backward_bytes":
                      mem["saved_for_backward_bytes"],
                  "live_peak_bytes": mem["live_peak_bytes"],
                  "flops_per_rank": rec["flops_per_rank"],
                  "bytes_accessed_per_rank": rec["bytes_accessed_per_rank"],
                  "sent_bytes": sum(c["bytes"]
                                    for c in rec["collectives"].values()),
                  "mm_launches": rec["mm_launch_count"],
                  "fits_80gb": rec["fits_80gb"]})
        matrix_trace_sum_s = sum(rec["trace_s"] for _, rec, _ in traced)

        # Qwen3-0.6B Mode A: the card's step against its meta trace
        cfg = configs.load_arch("qwen3-0.6b").model
        par = dataclasses.replace(
            configs.load_arch("qwen3-0.6b").parallel_for("train_4k"),
            use_kernel=True)
        shape = InputShape("lm_train", "train", 1024, 1)
        meta = D.trace_step(cfg, par, shape, ranks=1, agents=WIDTH_AGENTS)
        opt_cfg = optimizers.OptimizerConfig(state_dtype=par.opt_state_dtype)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        stats0 = torch.cuda.memory_stats()
        _, fn, args = D.step_and_arguments(cfg, par, opt_cfg, shape, 1, None,
                                           device="cuda",
                                           agents=WIDTH_AGENTS)
        torch.cuda.synchronize()
        stats1 = torch.cuda.memory_stats()
        requested = stats1["requested_bytes.all.current"] - \
            stats0["requested_bytes.all.current"]
        allocated = stats1["allocated_bytes.all.current"] - \
            stats0["allocated_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        base_peak = stats1["allocated_bytes.all.current"]
        with tally.uncounted():
            tally.COUNTS.clear()
            t1 = time.perf_counter()
            card = D.trace(fn, args)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t1
            launched = self._tally(tally.COUNTS)[2]
        peak = torch.cuda.max_memory_allocated()
        del fn, args
        torch.cuda.empty_cache()

        def by_key(rec):
            out: dict = {}
            for d in rec["mm_launches"]:
                key = tuple(d["key"])
                out[key] = out.get(key, 0) + d["count"]
            return out

        gates = {
            "mm_launches": (by_key(meta), launched),
            "mm_calls": (by_key(meta), by_key(card)),
            "flops": (meta["flops_per_rank"], card["flops_per_rank"]),
            "argument_bytes": (meta["memory"]["argument_bytes"], requested),
            # each block rounded to the allocator's 512-byte granule, as
            # torch.cuda.memory_allocated counts them
            "argument_alloc_bytes": (meta["memory"]["argument_alloc_bytes"],
                                     allocated),
        }
        mem = meta["memory"]
        emit({"phase": "dryrun_qwen3_mode_a", "agents": WIDTH_AGENTS,
              "seq_len": 1024, "meta_trace_s": meta["trace_s"],
              "card_step_s": card_s,
              "mm_launches": {str(k): v for k, v in launched.items()},
              "mm_launch_total": sum(launched.values()),
              "flops_meta": meta["flops_per_rank"],
              "flops_card": card["flops_per_rank"],
              "argument_bytes_meta": mem["argument_bytes"],
              "argument_requested_card": requested,
              "argument_alloc_bytes_meta": mem["argument_alloc_bytes"],
              "memory_allocated_card": allocated,
              "saved_for_backward_bytes": mem["saved_for_backward_bytes"],
              "predicted_peak_bytes": mem["predicted_peak_bytes"],
              "live_peak_bytes": mem["live_peak_bytes"],
              "max_memory_allocated": peak,
              "step_peak_over_arguments": peak - base_peak,
              "predicted_over_measured":
                  mem["predicted_peak_bytes"] / peak,
              "live_peak_over_measured": mem["live_peak_bytes"] / peak,
              "bytes_accessed_meta": meta["bytes_accessed_per_rank"],
              "bytes_accessed_card": card["bytes_accessed_per_rank"],
              "equal": {k: a == b for k, (a, b) in gates.items()}})
        for name, (want, got) in gates.items():
            assert want == got, (name, want, got)
        assert sum(launched.values()) == 14, launched

        # Mode B at fsdp_train's shape: bytes sent by kind, every rank and
        # step of fsdp_train's run
        assert self.fsdp_traffic, "the Mode B gate needs the fsdp_train phase"
        par_b = configs.ParallelConfig(fsdp=True, aggregation="rs_mm",
                                       use_kernel=True, remat=True,
                                       microbatches=1)
        rec_b = D.trace_step(cfg, par_b,
                             InputShape("fsdp_train", "train", 1024, DIST_K),
                             ranks=DIST_K)
        sent = {k: c["bytes"] for k, c in rec_b["collectives"].items()}
        emit({"phase": "dryrun_mode_b", "ranks": DIST_K,
              "meta_trace_s": rec_b["trace_s"], "sent_meta": sent,
              "sent_total_meta": sum(sent.values()),
              "collectives_meta": rec_b["collectives"],
              "sent_card_rank_steps": self.fsdp_traffic,
              "mm_launches_meta": rec_b["mm_launch_count"]})
        for t in self.fsdp_traffic:
            assert {k: n for k, n in t.items() if n} == sent, (t, sent)
        emit({"phase": "dryrun", "pairs": len(DRYRUN_PAIRS),
              "left_out": len(left), "matrix_s": matrix_s,
              "matrix_wait_s": matrix_wait_s,
              "matrix_trace_sum_s": matrix_trace_sum_s,
              "matrix_beside_phases": self.dryrun_beside,
              "qwen3_mode_a_gates": list(gates), "mode_b_gate": "sent_bytes"})

    # -- the benchmarks ------------------------------------------------------

    def bench(self):
        """The port's benchmarks (repro_torch.benchmarks), each a main
        path, from the checkout's root: paper_fig1 at 1000 iterations
        (every claim PASS, every steady MSD finite); run.py --only
        agg,kernel,roofline (every row finite, each kernel row within
        1e-5 x max(1, |x|_inf) of its plain version, a roofline row for
        each record the dryrun phase wrote); scenario_sweep --family
        large_cohort --json; serve_bench --json; bench_audit over the
        three JSON files in BENCH_DIR (every audit ok).  Each (variant,
        K, M, N) launched gets a kernels-line entry."""
        import os
        cwd = os.getcwd()
        os.chdir(HERE)          # the benchmarks' default outputs and inputs
        try:
            self._bench()
        finally:
            os.chdir(cwd)

    def _bench_step(self, label, fn):
        """fn() as a main path with its standard output kept: (result,
        output, launches, launches by (variant, K, M, N), seconds)."""
        import contextlib
        import io
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result, counts, _ = self.main_path(fn)
        seconds = time.perf_counter() - t0
        emit({"phase": "bench", "step": label, "seconds": seconds,
              "launches": counts,
              "by_shape": [list(k) + [v] for k, v in
                           sorted(self.by_shape.items())]})
        return result, out.getvalue(), counts, dict(self.by_shape), seconds

    def _bench(self):
        import io
        torch = self.torch
        from repro_torch.analysis import bench_audit
        from repro_torch.benchmarks import run as bench_run, serve_bench
        from repro_torch.examples import paper_fig1, scenario_sweep
        dev = str(self.dev)
        torch.cuda.empty_cache()
        BENCH_DIR.mkdir(parents=True, exist_ok=True)
        files = {kind: str(BENCH_DIR / f"BENCH_{kind}_torch.json")
                 for kind in ("agg", "large_cohort", "serve")}

        # the paper's Fig. 1 at its size: K = 32, d = 10, 1000 iterations;
        # every run_diffusion compiles its trajectory (the spy records
        # whether each program was captured as one CUDA graph)
        from repro_torch.scenarios import runner
        compile_trajectory, captured = runner.compile_trajectory, []

        def spy(*args, **kw):
            program = compile_trajectory(*args, **kw)
            captured.append(program.captured)
            return program

        runner.compile_trajectory = spy
        try:
            rc, out, counts, _, fig1_s = self._bench_step(
                "paper_fig1", lambda: paper_fig1.main(
                    ["--iters", "1000", "--device", dev]))
        finally:
            runner.compile_trajectory = compile_trajectory
        assert captured and all(captured), captured
        steady, claims = {}, {}
        lines = out.splitlines()
        for line in lines[1:-1]:
            name, value = line.split()
            if name.startswith("fig1/claim"):
                claims[name] = value
            else:
                steady[name] = float(value)
        # the last line: C3's clean ratio for each of its seeds
        ratios = [float(v) for v in
                  lines[-1].split(": ")[1].split(" (")[0].split()]
        emit({"phase": "bench_fig1", "rc": rc, "claims": claims,
              "c3_clean_ratios": ratios, "steady_msd": steady,
              "settings": len(steady), "seconds": fig1_s,
              "captured_trajectories": len(captured), "launches": counts})
        assert rc == 0 and len(claims) == 3 and \
            set(claims.values()) == {"PASS"}, claims
        assert len(steady) == 33 and all(math.isfinite(v)
                                         for v in steady.values()), steady

        # run.py --only agg,kernel,roofline
        csv = io.StringIO()
        (rows, failed), _, counts, run_shapes, run_s = self._bench_step(
            "run agg,kernel,roofline", lambda: bench_run.run(
                {"agg", "kernel", "roofline"}, out=csv, device=dev,
                agg_json=files["agg"]))
        (BENCH_DIR / "run.csv").write_text(csv.getvalue())
        assert not failed, csv.getvalue()[-2000:]
        bad = [r[:3] for r in rows if not math.isfinite(r[1]) or (
            isinstance(r[2], (int, float)) and not math.isfinite(r[2]))]
        assert not bad, bad
        kernel_rows = [{"name": r[0], "us": r[1], **r[3]} for r in rows
                       if r[0].startswith("kernel/") and len(r) > 3
                       and r[3] is not None]
        assert len(kernel_rows) == 13 and all(
            k["max_abs_err"] <= k["tol"] for k in kernel_rows), kernel_rows
        roof = [r for r in rows if r[0].startswith("roofline/")]
        if self.dryrun_records:
            assert len(roof) == self.dryrun_records == len(DRYRUN_PAIRS), roof
            assert {tuple(r[0].split("/")[1:3]) for r in roof} == \
                set(DRYRUN_PAIRS), roof
        with open(files["agg"]) as f:
            agg = json.load(f)
        emit({"phase": "bench_run", "seconds": run_s, "rows": len(rows),
              "launches": counts, "kernel_rows": kernel_rows,
              "agg_rows": [[r[0], r[1], r[2]] for r in rows
                           if not r[0].startswith(("kernel/", "roofline/"))],
              "substrate": agg["substrate"], "irls_sweep": agg["irls_sweep"],
              "traffic_audit": agg["traffic_audit"],
              "roofline": [[r[0], r[1], r[2]] for r in roof]})

        # the large-cohort family, and the service under chaos
        rc, _, _, sweep_shapes, _ = self._bench_step(
            "scenario_sweep large_cohort", lambda: scenario_sweep.main(
                ["--family", "large_cohort", "--json", files["large_cohort"],
                 "--device", dev]))
        assert rc == 0, rc
        rc, out, _, serve_shapes, _ = self._bench_step(
            "serve_bench", lambda: serve_bench.main(
                ["--json", files["serve"], "--device", dev]))
        assert rc == 0, out[-2000:]

        # the audits over the three files
        rc, out, _, _, _ = self._bench_step(
            "bench_audit", lambda: bench_audit.main(list(files.values())))
        emit({"phase": "bench_audit", "rc": rc, "lines": out.splitlines()})
        assert rc == 0, out

        for label, shapes in (("bench run", run_shapes),
                              ("bench large_cohort", sweep_shapes),
                              ("bench serve_bench", serve_shapes)):
            self.measure_launched(label, shapes, weighted=False,
                                  launches=BENCH_TIMED_LAUNCHES)

    def kernels_line(self) -> None:
        if self.contracts_ran:
            self._query_kernel_shapes()
        rows = []
        for entry in self.kernels.values():
            kernel = next((k for k in ("finite_scan", "two_pass", "residual")
                           if k in entry["name"]), "single_pass")
            assert entry["launches"] > 0, entry
            rows.append(dict(entry, route="cuda",
                             parity_max_abs_err=self.parity_err[kernel]))
        print(json.dumps({"kernels": rows}), flush=True)


# ===========================================================================
# the agent ranks of the sharded, fsdp_train and fsdp_serve phases: each
# runs in its own process (launch.mesh.run_ranks), DIST_K of them on
# cuda:0 over gloo, and returns plain numbers to the parent
# ===========================================================================

FSDP_SGD = dict(name="sgd", learning_rate=1.0, grad_clip=0.0, warmup_steps=0,
                schedule_kind="constant")


def _checksum(torch, t) -> int:
    """An order-sensitive integer checksum of a float32 tensor's bits."""
    bits = t.contiguous().view(torch.int32).reshape(-1)
    total = 0
    for lo in range(0, bits.numel(), 1 << 24):
        b = bits[lo:lo + (1 << 24)].to(torch.int64)
        w = torch.arange(lo, lo + b.numel(), device=b.device) % 65521 + 1
        total += int((b * w).sum())
    return total


def _rank_setup():
    """torch and a Smoke for this rank (its helpers; no phase runs)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, Smoke(torch, None)


def _time_blocks(smoke, blocks: dict) -> list:
    """Each (K, M) block's kernel, timed as the kernels line times it and
    held to its plain version on the same block."""
    torch = smoke.torch
    from repro_torch.kernels import mm_aggregate as mk
    rows = []
    for (k, m), x in sorted(blocks.items()):
        plan = mk.launch_plan(k, m, 1)
        uniform = torch.full((k, 1), 1.0 / k, device=smoke.dev)
        call = lambda: mk.single_pass(x, uniform, plan, weighted=False)
        call_ms, got = smoke.not_counted(lambda: smoke.time_ms(call))
        ms, _ = smoke.not_counted(lambda: smoke.kernel_ms(call))
        prof, by_name = smoke.not_counted(lambda: smoke.profiler_ms(call))
        plain_ms, err = smoke.plain_check(x, uniform, got, plan, False,
                                          chunk=2 ** 24)
        t, by = bound(plan.total_bytes, mm_ops(k, m, 1, False))
        rows.append(dict(k=k, m=m, variant=plan.variant, ms=ms,
                         call_ms=call_ms, profiler_ms=prof,
                         profiler_kernels=by_name, plain_ms=plain_ms,
                         max_abs_err=err,
                         tol=1e-5 * max(1.0, float(got.abs().max())),
                         bound_ms=t, bound_by=by, block_m=plan.block_m))
    return rows


def _probe_collectives(torch, sharded, axis, dev, mib: int = 256) -> dict:
    """Each collective core.sharded uses, on CUDA tensors of this
    backend: checked on a small tensor, then timed on ``mib`` MiB (host
    seconds, barrier to synchronize)."""
    import torch.distributed as dist
    k, r = axis.size, axis.index
    x = torch.arange(4 * k, dtype=torch.float32, device=dev) + 100 * r
    ag = sharded.all_gather(x, axis)
    assert torch.equal(ag[k - 1], x - 100 * r + 100 * (k - 1)), ag
    a2a = sharded.all_to_all(x.reshape(k, 4), axis)
    assert torch.equal(a2a[k - 1], x.reshape(k, 4)[r] + 100 * (k - 1 - r))
    rs = sharded.reduce_scatter_sum(x, axis)
    assert torch.equal(rs, k * x.reshape(k, 4)[r] - 100 * r * k
                       + 100 * k * (k - 1) / 2), rs
    ar = sharded.all_reduce_sum(x, axis)
    assert torch.equal(ar, k * (x - 100 * r) + 100 * k * (k - 1) / 2), ar
    big = torch.ones((k, mib * 2 ** 20 // 4 // k), device=dev)
    out = {}
    for name, fn in (("all_gather", lambda: sharded.all_gather(big[0], axis)),
                     ("all_to_all", lambda: sharded.all_to_all(big, axis)),
                     ("reduce_scatter",
                      lambda: sharded.reduce_scatter_sum(big, axis)),
                     ("all_reduce", lambda: sharded.all_reduce_sum(big, axis))):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
    out["mib"] = mib
    return out


def _sharded_rank(mesh, seed):
    """One agent of the sharded phase: its own update shaped like
    Qwen3-0.6B's tree through robust_all_reduce_tree (rs_mm, then mean)
    on the kernel, gated leaf by leaf; then one decoder layer's rs_mm
    against gather_mm and hier_mm against its pods' mean."""
    torch, smoke = _rank_setup()
    import torch.distributed as dist
    from repro_torch import pytree
    from repro_torch.core import sharded
    from repro_torch.kernels import mm_aggregate as mk
    dev, agents = smoke.dev, mesh.agents
    r, k = agents.index, agents.size
    probe = _probe_collectives(torch, sharded, agents, dev)
    shapes, treedef = qwen3_shapes()
    gen = torch.Generator(device=dev).manual_seed(seed * 1009 + r)
    leaves = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    if r == k - 1:
        for leaf in leaves:
            leaf.add_(DIST_DELTA)
    tree = pytree.unflatten(treedef, leaves)
    runs = {}

    def drive():
        for method in ("rs_mm", "mean"):
            dist.barrier()
            torch.cuda.synchronize()
            sent = dict(sharded.TRAFFIC)
            t0 = time.perf_counter()
            est = sharded.robust_all_reduce_tree(
                tree, agents, method=method, aggregator="mm_pallas")
            torch.cuda.synchronize()
            runs[method] = {
                "host_ms": (time.perf_counter() - t0) * 1e3,
                "sent": {c: sharded.TRAFFIC[c] - sent[c] for c in sent
                         if sharded.TRAFFIC[c] > sent[c]},
                "est": pytree.flatten(est)[0]}

    _, counts, variants = smoke.main_path(drive)
    by_shape = {str(key): n for key, n in smoke.by_shape.items()}
    # every leaf's local (K, M/K) block, as rs_mm's all-to-all gave it
    # (each Qwen3 leaf's size divides K: no pad), against the plain
    # version; one block of each shape kept for the kernels line
    uniform = torch.full((k, 1), 1.0 / k, device=dev)
    names = pytree.leaf_paths(tree)
    gates, blocks = [], {}
    for name, x, est in zip(names, leaves, runs["rs_mm"]["est"]):
        block = sharded.all_to_all(x.reshape(k, -1), agents)
        got = est.reshape(k, -1)[r:r + 1]
        plan = mk.launch_plan(k, block.shape[1], 1)
        plain_ms, err = smoke.plain_check(block, uniform, got, plan, False,
                                          chunk=2 ** 24)
        est_max = float(got.abs().max())
        gates.append({"leaf": name, "m": block.shape[1],
                      "variant": plan.variant, "max_abs_err": err,
                      "tol": 1e-5 * max(1.0, est_max), "est_max": est_max,
                      "finite": bool(torch.isfinite(est).all()),
                      "plain_ms": plain_ms})
        blocks.setdefault((k, block.shape[1]), block)
        del block
    checksums = {m: [_checksum(torch, e) for e in runs[m]["est"]]
                 for m in runs}
    for m in runs:
        del runs[m]["est"]
    del tree, leaves
    torch.cuda.empty_cache()
    # one decoder layer: rs_mm against gather_mm, hier_mm (2 pods x 2)
    # against the mean of its pods' gather_mm estimates
    m_layer = layer_width()
    g2 = torch.Generator(device=dev).manual_seed(seed * 7919 + r)
    x = torch.randn(m_layer, generator=g2, device=dev)
    if r == k - 1:
        x += DIST_DELTA
    pod, data = mesh.axis("pod"), mesh.axis("data")

    def layer():
        rs = sharded.rs_mm(x, agents, aggregator="mm_pallas")
        ga = sharded.gather_mm(x, agents, aggregator="mm_pallas")
        hier = sharded.robust_all_reduce(x, (pod, data), method="hier_mm",
                                         aggregator="mm_pallas")
        pods = sharded.all_gather(
            sharded.gather_mm(x, data, aggregator="mm_pallas"), pod)
        return rs, ga, hier, (pods[0] + pods[1]) / 2

    rs, ga, hier, pod_mean = smoke.not_counted(layer)
    tol = 1e-5 * max(1.0, float(ga.abs().max()))
    layer_row = {
        "m": m_layer, "tol": tol,
        "rs_mm_variant": mk.launch_plan(k, m_layer // k, 1).variant,
        "gather_mm_variant": mk.launch_plan(k, m_layer, 1).variant,
        "rs_vs_gather_max_err": float((rs - ga).abs().max()),
        "rs_equals_gather": bool(torch.equal(rs, ga)),
        "hier_inner_variant": mk.launch_plan(data.size, m_layer // data.size,
                                             1).variant,
        "pod_gather_variant": mk.launch_plan(data.size, m_layer, 1).variant,
        "hier_vs_pod_mean_max_err": float((hier - pod_mean).abs().max()),
        "hier_tol": 1e-5 * max(1.0, float(pod_mean.abs().max()))}
    del rs, ga, hier, pod_mean, x
    dist.barrier()          # the card is rank 0's alone while it times
    timing = _time_blocks(smoke, blocks) if r == 0 else []
    dist.barrier()
    return {"rank": r, "transport": sharded.transport(agents),
            "probe": probe,
            "launches": counts, "variants": variants, "by_shape": by_shape,
            "collectives": {m: {c: v for c, v in runs[m].items()}
                            for m in runs},
            "gates": gates, "checksums": checksums, "layer": layer_row,
            "timing": timing,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _fsdp_local(torch, cfg, seed, k, r):
    """This rank's Mode B shards of the seeded full model (the parent's
    Mode A model: the same generator on the same card)."""
    from repro_torch import pytree
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    full = pytree.tree_map(lambda t: t.detach(),
                           M.init_model(cfg, seed=seed, device="cuda").tree())
    local = steps.shard_params(full, k, r)
    del full
    torch.cuda.empty_cache()
    return local


def _fsdp_train_rank(mesh, ref_path, tokens):
    """One agent of fsdp_train: Mode B on full-size Qwen3-0.6B, its
    shards of the seeded model and its row of the batch.  A first SGD
    step at lr 1 without clip (its update held to Mode A's, which the
    parent computed), then FSDP_TRAIN_STEPS Adam steps with clip 1.0;
    the replicated leaves' drift across ranks after them."""
    torch, smoke = _rank_setup()
    import torch.distributed as dist
    from repro_torch import configs, pytree
    from repro_torch.core import attacks, sharded
    from repro_torch.kernels import launches as tally
    from repro_torch.kernels import mm_aggregate as mk
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers
    dev, agents = smoke.dev, mesh.agents
    r, k = agents.index, agents.size
    cfg = configs.load_arch("qwen3-0.6b").model
    local = _fsdp_local(torch, cfg, 0, k, r)
    leaves = pytree.flatten(local)[0]
    names = pytree.leaf_paths(local)
    dims = pytree.flatten(steps.fsdp_dims(steps.param_template(cfg), k))[0]
    par = configs.ParallelConfig(fsdp=True, aggregation="rs_mm",
                                 use_kernel=True, remat=True, microbatches=1)
    byz = attacks.ByzantineConfig(num_malicious=1, attack="additive",
                                  attack_kwargs=(("delta", DIST_DELTA),))
    sgd = optimizers.OptimizerConfig(**FSDP_SGD)
    # launch.train's Adam for a run of FSDP_TRAIN_STEPS steps, clip 1.0
    adam = optimizers.OptimizerConfig(learning_rate=3e-3, warmup_steps=1,
                                      total_steps=FSDP_TRAIN_STEPS)
    batch = {"tokens": torch.from_numpy(tokens[r:r + 1]).to(dev)}
    p0 = [t.detach().clone() for t in leaves]
    rows, stash, state = [], {}, {}

    def one(step, opt, label):
        before = tally.COUNTS.copy()
        sent0 = dict(sharded.TRAFFIC)
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, opt, m = step(local, opt, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        launches, variants, by_shape = smoke._tally(tally.COUNTS - before)
        rows.append({"step": label, "rank": r, "host_ms": host_ms,
                     "device_ms": step.phase_ms(), "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "launches": launches, "variants": variants,
                     "by_shape": {str(key): n for key, n in by_shape.items()
                                  if n},
                     "sent_bytes": step.traffic,
                     # every collective of the step, by kind (the
                     # dryrun phase holds its meta trace to these)
                     "traffic": {kind: n - sent0[kind] for kind, n
                                 in sharded.TRAFFIC.items()},
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated()})
        return opt

    def run():
        one(steps.make_train_step_fsdp(cfg, par, sgd, mesh, byz),
            optimizers.init(sgd, local), "sgd")
        with torch.no_grad():
            state["update"] = [a - b for a, b in zip(p0, leaves)]
            for p, q in zip(leaves, p0):
                p.copy_(q)
        p0.clear()
        step = steps.make_train_step_fsdp(cfg, par, adam, mesh, byz)
        opt = optimizers.init(adam, local)
        for i in range(FSDP_TRAIN_STEPS):
            last = r == 0 and i == FSDP_TRAIN_STEPS - 1
            orig = mk.single_pass
            if last:
                # keep one input of each (K, M) the last step aggregates,
                # for the kernels line (the clone is no launch)
                def spy(x, a, plan, **kw):
                    stash.setdefault(tuple(x.shape), x.clone())
                    return orig(x, a, plan, **kw)
                mk.single_pass = spy
            try:
                opt = one(step, opt, f"adam{i + 1}")
            finally:
                mk.single_pass = orig

    _, counts, variants = smoke.main_path(run)
    by_shape = {str(key): n for key, n in smoke.by_shape.items()}
    # gates (a) and (b): the SGD update against Mode A's, and against
    # the benign agents' mean gradient (Mode A's stacks)
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    gates = []
    for i, (name, d) in enumerate(zip(names, dims)):
        want, benign = ref["update"][i], ref["benign"][i]
        if d >= 0:
            n = want.shape[d] // k
            want, benign = want.narrow(d, r * n, n), benign.narrow(d, r * n, n)
        want, benign = want.to(dev), benign.to(dev)
        upd = state["update"][i]
        diff = (upd - want).abs()
        want_max = float(want.abs().max())
        gates.append({"leaf": name, "rank": r, "fsdp_dim": d,
                      "size": want.numel(), "max_err": float(diff.max()),
                      "off": int((diff > 1e-6 + 1e-5 * want.abs()).sum()),
                      "want_max": want_max, "tol_max": 2.0 ** -8 * want_max,
                      "max_dev_from_benign_mean": float(
                          (upd - benign).abs().max()),
                      "min_mean_shift": float(ref["shift"][i]),
                      "finite": bool(torch.isfinite(upd).all())})
        del want, benign, diff
    del ref, state["update"]
    # (d): the replicated leaves' drift from rank 0's copy
    drift = {}
    with torch.no_grad():
        for name, t, d in zip(names, leaves, dims):
            if d < 0:
                buf = t.detach().clone()
                dist.broadcast(buf, src=0)
                drift[name] = float((t - buf).abs().max())
                del buf
    dist.barrier()          # the card is rank 0's alone while it times
    timing = _time_blocks(smoke, stash) if r == 0 else []
    dist.barrier()
    return {"rank": r, "rows": rows, "gates": gates, "drift": drift,
            "launches": counts, "variants": variants, "by_shape": by_shape,
            "timing": timing, "transport": sharded.transport(agents)}


def _fsdp_serve_rank(mesh, ref_path, prompt):
    """One agent of fsdp_serve: its shards of the seeded model serve its
    row of the prompt: a timed prefill, decode logits teacher-forced on
    Mode A's greedy tokens (FSDP_SERVE_CHECKED positions), then
    FSDP_SERVE_TOKENS greedy tokens through the step, timed."""
    torch, smoke = _rank_setup()
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import sharded
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    dev, agents = smoke.dev, mesh.agents
    r, k = agents.index, agents.size
    cfg = configs.load_arch("qwen3-0.6b").model
    v = cfg.vocab_size
    local = _fsdp_local(torch, cfg, 1, k, r)
    ref = torch.load(ref_path, weights_only=True)
    toks = torch.from_numpy(prompt[r:r + 1]).to(dev)
    prefill = steps.make_prefill_step(cfg, "cuda", fsdp=True, mesh=mesh)
    dist.barrier()
    sent = sum(sharded.TRAFFIC.values())
    prefill_ms, last = smoke.time_ms(lambda: prefill(local, {"tokens": toks}),
                                     reps=1)
    prefill_sent = (sum(sharded.TRAFFIC.values()) - sent) // 2
    prefill_err = float((last[0, 0, :v].float()
                         - ref["prefill"][r].to(dev)).abs().max())
    hook = steps.make_serve_hook(mesh, steps.block_dims_tree(
        steps.param_template(cfg)["blocks"], k))
    cache = M.init_cache(cfg, 1, FSDP_SERVE_CHECKED, device="cuda")
    errs = []
    with torch.no_grad():
        for t in range(FSDP_SERVE_CHECKED):
            tok = toks[:, :1] if t == 0 else \
                ref["tokens"][r:r + 1, t - 1:t].to(dev)
            logits, cache = M.decode_step(local, cfg, tok, cache,
                                          layer_hook=hook)
            errs.append(float((logits[0, 0, :v].float()
                               - ref["logits"][r, t].to(dev)).abs().max()))
    decode = steps.make_decode_step(cfg, "cuda", fsdp=True, mesh=mesh)
    cache = M.init_cache(cfg, 1, FSDP_SERVE_TOKENS, device="cuda")
    dist.barrier()
    torch.cuda.synchronize()
    sent = sum(sharded.TRAFFIC.values())
    t0 = time.perf_counter()
    tok, out = toks[:, :1], []
    for _ in range(FSDP_SERVE_TOKENS):
        tok, cache = decode(local, tok, cache)
        out.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / FSDP_SERVE_TOKENS
    gen = torch.cat(out, dim=1).cpu()
    return {"rank": r, "prefill_ms": prefill_ms, "prefill_max_err": prefill_err,
            "prefill_sent_bytes": prefill_sent,
            "decode_vs_mode_a_max_err": errs,
            "tol": LM_SERVE_TOL * max(1.0, float(ref["logits"][r].abs().max())),
            "decode_ms_per_token": decode_ms,
            "decode_sent_bytes_per_token":
                (sum(sharded.TRAFFIC.values()) - sent) // FSDP_SERVE_TOKENS,
            "greedy_tokens_as_mode_a": int(
                (gen[0] == ref["tokens"][r, :FSDP_SERVE_TOKENS]).sum()),
            "generated_head": gen[0, :8].tolist(), "vocab": v,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _dryrun_matrix(pairs):
    """The dry run's DRYRUN_PAIRS on meta tensors, one after another, in
    a process of their own: ([((arch, shape), record, error)], the wall
    seconds from the first trace to the last)."""
    from repro_torch.launch import dryrun as D
    t0 = time.perf_counter()
    traced = [D._traced((arch, shape, False, None, D.AGENT_RANKS))
              for arch, shape in pairs]
    return traced, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=PHASES)
    args = ap.parse_args(argv)
    if not (HERE / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py drives the port on a GPU",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch, args)
    seconds = {}
    t_all = time.perf_counter()
    pool = None
    try:
        for phase in PHASES:
            if phase in args.phases:
                if pool is None and "dryrun" in args.phases and \
                        PHASES.index(phase) >= PHASES.index(DRYRUN_MATRIX_FROM):
                    pool = torch.multiprocessing.get_context("spawn").Pool(1)
                    smoke.dryrun_matrix = pool.apply_async(
                        _dryrun_matrix, (DRYRUN_PAIRS,))
                if pool is not None and phase != "dryrun" \
                        and not smoke.dryrun_matrix.ready():
                    smoke.dryrun_beside.append(phase)
                t0 = time.perf_counter()
                if phase in LM_TRAIN_RUNS:
                    smoke.lm_train_run(phase)
                elif phase in LM_SERVE_RUNS:
                    smoke.lm_serve_run(phase)
                else:
                    getattr(smoke, phase)()
                seconds[phase] = time.perf_counter() - t0
                emit({"phase_seconds": phase, "seconds": seconds[phase]})
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    emit({"phase_seconds": seconds,
          "total_s": time.perf_counter() - t_all})
    smoke.kernels_line()
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
