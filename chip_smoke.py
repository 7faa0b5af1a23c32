#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--log2-rows 25] [--compare-with TREE]
    python3 chip_smoke.py --mesh-tp-only [PORT_SRC]

Phases, one JSON line each; any failure raises and the exit code is not 0.
The numpy draws of the ``e2e`` databases run on a host thread beside the
build; those of the ``executor`` phase's database, the training corpus
with its oracle and the ``mesh`` phase's relations on host threads beside
the ``executor`` phase's first two parts, which wait for them before
``speculate`` (``in_background``):

1. ``device``  — the card's name and ``nvidia-smi`` name / power limit.
2. ``build``   — every CUDA source compiled with ``nvcc`` for ``sm_90a``
   from the sources in this checkout, one ``nvcc`` per source, all started
   together (registers / shared memory from ptxas).
3. ``kernel``  — the bucketed probe (the hash join of
   ``csrc/probe_hash.cu``: table build and table probe, slots hashed by the
   exact row) against its plain torch band version on the card, exactly, on a case list (key widths
   1/2/4/126, empty sides, all-duplicate keys, forced ``fp = 0`` and
   ``fp = key % 4`` collisions, int32 extremes, ragged sizes, a table at
   its load limit of 0.5 and one just past a doubling) and on one shard's
   probe inputs captured from the full-size MSJ run (copied with their
   aliasing, so their distinct bytes give the bound); then times the
   wrapper, its table fill, table build and table probe alone, the plain
   version and ``torch.isin`` at that shape.  ``costmodel``: the hash join
   and the torch sort-merge probe (``msj.probe_sorted``) timed at a
   2**14-row shard and at that main-path shard, beside the cost model's
   prices and choice at both and the kernel row weight their times fit.
4. ``e2e``     — the A3 family (guard R arity 4, four unary conditionals
   sharing key x) through the planner and ``execute_plan`` on 16 shards:
   the 1-ROUND plan at 2**log2-rows rows per relation and the GREEDY plan
   (MSJ + EVAL) at half of that, each with ``probe_backend="auto"``
   (every MSJ job must resolve to the kernel) and ``"sorted"``; outputs
   and counters must be bit-identical.  Every kernel's launch counter is
   set to 0 just before the measured ``auto`` run of a path and read just
   after; each kernel of the path must have launched, and the probe
   wrapper's count must be its table-build plus table-probe launches.  One more ``auto``
   run with a synchronizing tracer splits the wall into the operators'
   phases (count, bloom, shuffle, probe, scatter, EVAL).
5. ``bloom``   — the bloom build, pack and packed-probe kernels of
   ``csrc/bloom.cu`` (each row hashed in the kernel) against their plain
   versions from ``positions``, exactly, on a case list (bits 128 to 2**24,
   384 and 1000 among them; 0, 1 and ragged row counts; KW = 2 column
   views with a stride-0 signature; all rows inactive; one row repeated;
   rows whose positions hit the last bit or bit 31 of a word) and on shard
   0's wrapper inputs captured from the bloom run below (the build's rows;
   the received stack and the first probe's rows).  Times there each
   kernel alone, each wrapper as ``run_msj`` calls it, the plain version
   and the one-call torch yardstick.  ``--compare-with TREE`` also times
   another checkout's bloom wrappers on the same inputs, in turns.
   Then ``e2e`` ``one_round_bloom``: the 1-ROUND plan on the GREEDY
   phase's database with ``bloom_bits`` = one bit per guard row, held
   bit-identical between ``auto`` and ``sorted`` and equal in outputs and
   forward capacity (and no larger in forward bytes) to ``bloom_bits=0``.
6. ``blocked`` — the all-pairs probe (the same hash join) against its
   plain all-pairs version and the dense oracle on the same case list,
   timed at shard 0's inputs of an MSJ run at 2**20 rows per relation;
   then that run with ``probe_fn`` = the all-pairs probe and with the
   bucketed probe, each held bit-identical to the same run with the
   torch sort-merge probe (``msj.probe_sorted``), which shares no code
   with the hash join.
   (Cut to 2**20: its plain version is O(rows**2) per shard.)
7. ``executor`` — the executor's scheduling modes and fault tolerance,
   every MSJ job on ``probe_backend="auto"`` (each must run the hash join),
   the launch counters set to 0 before each run and read after; one line
   per part with its seconds, probe launches and peak (parts ``edges``,
   ``isolate`` and ``shrink`` read one database of their base relations,
   drawn on the host while ``waves`` runs).  ``waves``: the
   GREEDY plan on the GREEDY phase's database as barrier waves (unbounded,
   then two slots) and as the async walk on two slots, outputs and every
   job's counters equal to the ``e2e`` ``greedy`` run's.  ``edges``: C4
   planned ``parunit`` at 2**22 rows per relation on two slots under
   relation edges, strata edges, and relation edges on the sort-merge
   probe, bit-identical.  ``speculate``: the reference's fused star (six
   arity-4 guards, one unary ``S``) at 2**22 rows on two slots of a
   ``SlotScheduler``, after a warm run; the last job's first attempt
   straggles 30x (``wall_scale``): with speculation exactly one clone,
   and it wins, on real walls (each deadline printed, and the largest
   wall over its deadline of a job that does not straggle), a smaller
   makespan, outputs equal to the run without speculation and to the
   sort-merge run, the probe launched once more per clone; a clone that
   dies falls back to the original; a forced overflow with ``cap_slack``
   0.5 relaxes the shared retry state once (sizes ``(None, None)``, ``(None,
   1.0)``, ``(None, 1.0)``) and leaves the ``ExecutorConfig`` as it was.
   ``isolate``: the reference's three poison tenants (one guarding on
   ``PG``) in one 1-ROUND plan at 2**22 rows under ``fail_policy="isolate"``
   with every job reading ``PG`` failing: the failed units and tainted
   relations equal those of the same plan run on the CPU at 2**8 rows, the
   untainted outputs equal the fault-free run's.  ``shrink``: A4 planned
   PAR at 2**22 rows on two slots with ``shrink_on_shard_loss``, shard 0
   of the first job's first lineage relation lost once: one recovery, the
   later dispatches on slot 0, outputs equal the fault-free run's, the
   recovered relation equal to its lineage source.
8. ``service`` — the SGF query service (``repro_torch.service``) on a
   catalog resident on the card: the four tenants of the reference's
   service bench (guards R, G, H of arity 4, unary S, T, U, V) at
   2**21 rows per relation (at most 2**(log2-rows - 3)), P=16.  Ticks, one line
   each, every kernel counter set to 0 just before and read just after:
   ``baseline`` (each tenant through its own ``Executor`` and GREEDY plan,
   after a warm-up), ``cold`` (all four fused in one ``tick()``, equal as
   sets to the baseline; ``cold_sorted`` repeats it on a fresh service
   with the torch sort-merge probe, which must give bit-identical outputs
   and equal per-job counters; ``cold_traced`` repeats it with a
   synchronizing tracer for its phase seconds), ``warm`` (0 jobs,
   0 bytes, bit-identical), ``unrelated_register`` (still warm),
   ``dependent_register`` (``S`` re-registered: every query runs again
   with the semi-joins not on ``S`` served from the cache), ``sanitized``
   (the happens-before sanitizer on, traced and metered, its report
   exported to ``chiprun_out/service_tick.trace.json``, which must
   validate, audit clean and replay bit-exactly), ``chaos`` (shard 3 of R
   lost on the first job that reads R and one injected fault: recovered
   bit-identically from the catalog, whose R stays intact) and ``bloom``
   (``bloom_bits`` = one bit per row).  Every cold tick's MSJ jobs must
   run the probe kernel.  Then one tick at 2**12 rows set-equal to
   ``ref_engine`` (its line times the tick and the oracle apart).
9. ``oracle``  — the quickstart query on the card under PAR / GREEDY /
   1-ROUND, and 1-ROUND with the bloom prefilter, set-equal to the
   set-semantics oracle ``ref_engine``.
10. ``examples`` — the reference's ``examples/`` scripts as the port runs
   them (``repro_torch.examples``): each module's ``main`` in this process
   on the card, in a temporary working directory, at the script's own
   defaults (``train_lm``: 200 steps of the SMOKE qwen3-0.6b at 8 x 128),
   one line each with its wall, the numbers it printed and its launches
   (counters set to 0 just before).  Every MSJ job runs the backend the
   cost model picks for card-resident data (``EXAMPLE_BACKENDS``: the hash
   join, but for the PAR plan's all-pairs job on the 9-row ``Blocked``)
   and each kernel job launches the table build and probe; quickstart and
   data_pipeline print the reference scripts' numbers exactly, sgf_service
   its tick 1 (4 canonical queries, 4 deduped, 2 jobs, 1,018,184 bytes)
   and a warm tick 2 (0 jobs, 0 bytes) and writes a trace that parses;
   serve_lm's tokens equal those of its requests served on the CPU with
   the card's weights (float32, TF32 off); train_lm's stage 1 keeps 1,934
   documents in 1 job and 248,948 bytes, its loss falls, and one step on
   the card and one on the CPU from the same state agree within 1e-3.
11. ``lm_serve`` — the model zoo's serving path (``repro_torch.models``,
   ``repro_torch.serve``), once per family at its published size, random
   weights from ``--seed`` (``LM_SERVE``): qwen3-0.6b (dense),
   olmoe-1b-7b (MoE, 64 experts top-8), falcon-mamba-7b (Mamba-1) and
   zamba2-7b (Mamba-2 + shared attention); one line per step.
   ``card_vs_cpu``: prefill of 64 tokens and 2 decode steps on the card
   and on the CPU, float32 with TF32 off, max |Δlogit| / max |logit| ≤
   1e-3 (the 7B models at full width with their depth cut, so that the
   host's copy stays small: 2 layers, zamba2 one group and one tail
   layer).  ``teacher_forcing``: prefill(S-1) + decode(1) against
   forward(S) at S = 1021 (a prime), the whole model in float32, ≤ 2e-3.
   ``moe_dispatch`` (olmoe): one layer's ``moe_sort`` against
   ``moe_dense`` over 2048 tokens, ≤ 1e-4 with nothing dropped, and the
   dropped pairs at capacity factor 1.25 against a recount on the host.
   ``scan`` (falcon-mamba): one layer's chunked ``mamba1`` against its
   step-by-step ``mamba1_decode`` at S = 256, ≤ 1e-3.  ``batching``: the
   continuous batcher (8 requests of 17–300 tokens, 16 new each, 4
   slots) against unbatched greedy generation, float32, tokens exactly
   equal.  ``serve``: 32 requests of 128–2048 tokens (zamba2: 16), 128
   new each (the 7B models: 64), 16 slots of 4096 positions (zamba2: 8)
   in bf16, timed per prefill and per decode wave against the wave's
   bytes over HBM (weights, valid KV, SSM states read and written; for
   olmoe also with only the routed experts' weights), with a profiler
   trace of three decode waves and the share of first tokens equal to
   float32's.  ``sdpa_yardstick`` (qwen3): the port's flash attention and
   ``scaled_dot_product_attention`` at 2048 tokens (the yardstick is never
   on the path).  The stub-frontend families follow, whole: phi-3-vision-4.2b
   (VLM, 576 patch embeddings per request) and seamless-m4t-medium (enc-dec,
   512 frames), each with ``card_vs_cpu`` (phi-3-vision's depth cut to 2
   layers), ``teacher_forcing`` (S = 1021 text tokens after the
   embeddings), ``batching`` (``greedy_generate`` on 4 requests against
   each alone, float32, tokens equal) and ``serve``: bf16
   ``greedy_generate`` over two batches of 8 requests (text 512 and 1,472
   tokens after the patches; 256 and 1,024 after the frames), 64 new
   tokens each, prefill and every decode step timed against the step's
   bytes (weights, valid self K/V, the enc-dec's cross K/V), with a
   profiler summary of three decode steps.  No kernel of the repo is on
   these paths: the launch counters, set to 0 before each family, stay 0.
12. ``train``  — the training path.  ``pipeline``: the reference's Keep
   query (three negated semi-joins and one positive) over a 2**24-document
   crawl shard (``data.synthetic.corpus_relations``), P=16, 1-ROUND,
   through ``data.pipeline.filter_corpus`` on the card with every launch
   counter set to 0 just before: the probe kernel must launch (table
   builds and probes), bloom must not; kept ids equal to a numpy oracle,
   outputs and per-job counters bit-identical to ``probe_backend="sorted"``.
   ``grad_card_vs_cpu``: qwen3-0.6b at full width, 2 layers, float32: loss
   and every gradient ≤ 1e-3 of each leaf's max.  ``flash_grad``: the flash
   backward at 2048 tokens against dense autograd (≤ 1e-3), then its
   forward + backward timed beside ``scaled_dot_product_attention``'s.
   ``train``: qwen3-0.6b whole, float32 parameters and moments, bf16
   compute, full remat, 8 × 4096 tokens in 2 microbatches per step, batches
   seeded from the kept ids: step ms, tokens/s, share of the bf16 peak,
   peak bytes; step-1 loss within 0.1 of ln(vocab).  ``restart``:
   ``run_train_loop`` crashed at step 3 (checkpoints every 2 steps into a
   temporary directory, removed after), resumed: the loaded state bit for
   bit the saved one, resumed losses within 1e-3 of an uninterrupted run.
13. ``mesh``   — the multi-card layer (``repro_torch.launch.mesh``,
   ``engine.comm.MeshComm``, the sharding rules, sharded train state,
   reshard-on-load).  One card: NCCL at world size 1, and four gloo ranks
   sharing the card (NCCL refuses two ranks on one device; gloo stages card
   tensors through the host), spawned once after the kernels are built.
   ``mesh_msj``: the A3 job's map, probe and out stages at 2**24 rows, one
   gloo rank per shard (P = 4), each rank's result bit for bit its shard of
   ``run_pipeline`` under ``SimComm(4)`` (the count-sized ``forward_cap``
   fixed in the parent), every rank's probe counters from 0 around its
   measured run and each launching the kernel; then P = 1 over NCCL against
   ``SimComm(1)``.  ``mesh_train``: qwen3-0.6b whole on the (1, 1) NCCL
   mesh, its state placed by ``state_specs``, two steps of the ``train``
   batch against two unsharded steps from the same seed, bit for bit under
   deterministic algorithms (else each differing leaf within 1e-6 in
   |Δ|₂), both timed; a checkpoint saved with ``mesh=`` and loaded with
   ``specs=``, and ``reshard_state`` onto a fresh (1, 1) mesh, bit for bit.
   ``mesh_train_4``: four gloo ranks on (data, model) = (2, 2),
   qwen3-0.6b at its width with 2 layers, float32, TF32 off, two steps of
   4 × 1024 tokens, each layer gathered over ``data`` as it runs and
   computed tensor-parallel over ``model`` (``models.parallel``): each
   rank's state bytes equal the sum of its shards as ``state_specs`` gives
   them, losses and gradient norms within 1e-5 of one rank's run and each
   parameter leaf within 1e-5 in |Δ|₂ / |p|₂ (AdamW's default eps), each
   rank's peak below the whole-model gather's
   (``MESH_TRAIN_4_WHOLE_GATHER_PEAK``) and its gathered bytes live at
   once (the gather's counter) within one layer plus ``embed`` or
   ``lm_head``, the (2, 2) checkpoint loaded onto (1, 1) bit for bit.
   ``mesh_tp_4``: the same four ranks, the SSM, hybrid and enc-dec
   families tensor-parallel over ``model``.  falcon-mamba-7b at its width
   (d_model 4096, d_inner 8192, N 16, vocabulary 65,024), 2 layers,
   float32, two steps of 4 × 1024 tokens, checked as ``mesh_train_4`` is
   but for the parameter elements that one rank does not itself repeat
   when its gradient sum is regrouped (``twin_compare``; at most one in
   10⁴; each leaf's count printed, and the mesh against that regrouped
   run over every element), and the first step's gradients (AdamW's first
   moments then) over every element of every leaf; each rank's peak
   below the same run's on the tree that gathered each layer whole
   (``MESH_TP_TRAIN_LAYER_GATHER_PEAK``); zamba2-7b (one group of 6
   Mamba-2 layers and the shared block) and seamless-m4t-medium (2 + 2
   layers) at their widths, float32: a sharded prefill and 8 decode steps,
   each rank's logits within 1e-5 in |Δ|₂/|w|₂ per step of a float64
   one-rank run's on its rows (run in this process after the spawn; the
   float32 one-rank run's own distance to it printed beside, and a
   bfloat16 one-rank run as the control, which must land above 1e-5), the
   cache back in ``cache_specs``' placements, no SSM state gathered over
   ``model`` (``models.parallel.CACHE_GATHERS``).  ``--mesh-tp-only``
   runs this part alone (four ranks, then its checks); ``--mesh-tp-only
   PORT_SRC`` (another checkout's ``src``) only its training, on that
   port, printing each rank's peak: so ``MESH_TP_TRAIN_LAYER_GATHER_PEAK``
   was read on the parent tree's port.

14. ``dryrun`` — the multi-pod dry-run (``repro_torch.launch.dryrun``,
   ``launch.opcost``, ``launch.roofline``) held to real steps.  Two spawned
   processes trace, each as rank 0 of a fake process group on a fake
   (1, 1) mesh, qwen3-0.6b's train step at the ``train`` batch (8 × 4096,
   2 microbatches, full remat) and its decode step at batch 8 against a
   32,768-token cache (about 30 GB in bf16), while the script runs both for
   real on the (1, 1) NCCL mesh, each once under ``FlopCounterMode`` and
   once timed (the traces and the CLI runs below need no card time: they
   start before the ``train`` phase and run beside it and ``mesh``): the
   traced matmul FLOPs must equal ``FlopCounterMode``'s,
   the predicted peak above the step's start must lie within 10 % of
   ``max_memory_allocated``'s, and the measured step must take at least
   ``step_lower_bound_s`` (the ratio is printed).  Two more processes run
   the CLI for qwen3-0.6b ``train_4k`` on the production meshes (16, 16)
   and (2, 16, 16) on fake groups of 256 and 512 ranks; each record is
   printed.  No kernel of the repo is on these paths.

Then a ``kernels`` JSON line (``launches`` count the executor phase's,
the examples', the pipeline's and the mesh ranks' too), the
raw ``nvidia-smi`` name/power line, and as the last line ``{"ok": true,
"device": {...}}``.  Without a CUDA device it exits 1 before printing any
result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: ``--mesh-tp-only PORT_SRC``: another checkout's port, for this process and its ranks
PORT_SRC_ENV = "CHIP_SMOKE_PORT_SRC"
sys.path.insert(0, os.environ.get(PORT_SRC_ENV) or str(ROOT / "src"))

DEVICE = "cuda"
SHARDS = 16  # P of the main path
REPS = 20  # timed launches per measured kernel
BLOCKED_LOG2_ROWS = 20  # rows per relation of the all-pairs probe's run
SERVICE_LOG2_ROWS = 21  # rows per relation of the service's catalog
COSTMODEL_SMALL_LOG2 = 14  # rows a side of the cost model's small shard
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (after one warm-up),
    from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.bloom import ops as bloom_ops
    from repro_torch.kernels.msj_probe import ops

    return {"probe_bucketed": ops.probe_bucketed, "probe_blocked": ops.probe,
            "table_build": ops.table_build_cuda, "table_probe": ops.table_probe_cuda,
            "bloom_build": bloom_ops.build, "bloom_pack": bloom_ops.pack,
            "bloom_probe": bloom_ops.probe_packed}


def check_probe_launches(name, launches, wrapper) -> None:
    """The probe wrapper's count is the launches of its two kernels, one
    table build and one table probe per hash join."""
    build, probe_ = launches["table_build"], launches["table_probe"]
    if launches[wrapper] != build + probe_ or build != probe_:
        raise AssertionError(f"{name}: {wrapper} counted {launches[wrapper]} launches, "
                             f"its kernels {build} table builds and {probe_} table probes")


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def bound(in_bytes: int, out_bytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over HBM rate against
    scalar operations over the float32 rate outside the tensor cores."""
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {"bytes": in_bytes + out_bytes, "ops": ops, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# --------------------------------------------------------------------------
# phase 3: kernel vs plain
# --------------------------------------------------------------------------


def probe_case(gen, nb, np_, kw, lo, hi, fp_mode=None, values=None):
    """Random probe inputs on the card: ``(args, kwargs)`` of probe_fn.
    Keys are drawn from ``[lo, hi)``, or from ``values`` when given."""
    import torch

    def ints(*shape, a=lo, b=hi):
        return torch.randint(a, b, shape, generator=gen, dtype=torch.int64,
                             device=DEVICE).to(torch.int32)

    if values is None:
        bk, pk = ints(nb, kw), ints(np_, kw)
    else:
        pool = torch.tensor(values, dtype=torch.int32, device=DEVICE)
        bk = pool[ints(nb, kw, a=0, b=len(values)).long()]
        pk = pool[ints(np_, kw, a=0, b=len(values)).long()]
    args = (ints(nb, a=0, b=3), bk, torch.rand(nb, generator=gen, device=DEVICE) < 0.7,
            ints(np_, a=0, b=3), pk, torch.rand(np_, generator=gen, device=DEVICE) < 0.7)
    kwargs = {}
    if fp_mode == "zero":
        kwargs = {"build_fp": torch.zeros_like(bk[:, 0]), "probe_fp": torch.zeros_like(pk[:, 0])}
    elif fp_mode == "mod4":
        kwargs = {"build_fp": torch.remainder(bk[:, 0], 4), "probe_fp": torch.remainder(pk[:, 0], 4)}
    return args, kwargs


def distinct_case(gen, nb, np_):
    """Every build row valid and distinct (KW = 1), so the hash table holds
    nb rows; about a quarter of the probe rows hit."""
    import torch

    keys = (torch.randperm(4 * nb, generator=gen, device=DEVICE)[:nb] - 2 * nb).to(torch.int32)
    pk = torch.randint(-2 * nb, 2 * nb, (np_, 1), generator=gen, device=DEVICE).to(torch.int32)
    return ((torch.zeros(nb, dtype=torch.int32, device=DEVICE), keys[:, None],
             torch.ones(nb, dtype=torch.bool, device=DEVICE),
             torch.zeros(np_, dtype=torch.int32, device=DEVICE), pk,
             torch.rand(np_, generator=gen, device=DEVICE) < 0.9), {})


def kernel_cases(gen):
    extremes = (-(2**31), -(2**31) + 1, -2, -1, 0, 1, 2**31 - 2, 2**31 - 1)
    return {
        "kw1": probe_case(gen, 6000, 5000, 1, -1000, 1000),
        "kw2": probe_case(gen, 6000, 5000, 2, -30, 30),
        "kw4": probe_case(gen, 5000, 6000, 4, -4, 4),
        "kw126_wide": probe_case(gen, 1500, 1300, 126, 0, 1),
        "empty_build": probe_case(gen, 0, 300, 1, 0, 5),
        "empty_probe": probe_case(gen, 300, 0, 1, 0, 5),
        "all_duplicate": probe_case(gen, 4000, 4000, 1, 7, 8),
        "fp_zero": probe_case(gen, 4000, 3000, 2, -50, 50, "zero"),
        "fp_key_mod4": probe_case(gen, 4000, 3000, 2, -50, 50, "mod4"),
        "int32_extremes": probe_case(gen, 3000, 3000, 2, 0, 0, values=extremes),
        "ragged_1x1": probe_case(gen, 1, 1, 1, 0, 2),
        "ragged_127x129": probe_case(gen, 129, 127, 1, 0, 40),
        "ragged_385x1000": probe_case(gen, 1000, 385, 2, 0, 20),
        # 2**16 rows fill 2**17 slots to the load limit; one more doubles them
        "table_load_half": distinct_case(gen, 2**16, 50_000),
        "table_slots_doubled": distinct_case(gen, 2**16 + 1, 50_000),
    }


def _view_key(t):
    """What identifies the elements a view reads: where it starts, its dtype
    and its sizes and strides, size-1 dims aside."""
    return (t.data_ptr(), t.dtype,
            tuple((n, st) for n, st in zip(t.shape, t.stride()) if n != 1))


def _compact(t):
    """The elements a view reads: each stride-0 (broadcast) dim cut to one."""
    return t[tuple(slice(0, 1) if st == 0 else slice(None) for st in t.stride())]


def distinct_bytes(tensors) -> int:
    """Bytes a function must read of ``tensors``: each distinct view once,
    a broadcast view's element once."""
    return sum({_view_key(t): _compact(t).numel() * t.element_size()
                for t in tensors}.values())


def copy_inputs(tensors) -> list:
    """Contiguous copies that keep the call's aliasing: views of the same
    elements share one copy, and a broadcast view stays a broadcast of one
    copied element, so a kernel reads them as it did on the main path.
    (Copies, because views would keep the whole exchange alive.)"""
    import torch

    distinct = {}
    for t in tensors:
        if _view_key(t) not in distinct:
            distinct[_view_key(t)] = _compact(t).clone(memory_format=torch.contiguous_format)
    copies = [distinct[_view_key(t)] for t in tensors]
    return [c.view(t.shape) if c.numel() == t.numel() else c.expand(t.shape)
            for c, t in zip(copies, tensors)]


def capture_main_path_probe(db, sjs, P, probe_fn=None):
    """One shard's probe_fn inputs from a full-size MSJ run (shard 0):
    ``((args, kwargs), in_bytes)``, where ``in_bytes`` is what the card's
    hash join must read of them (``args``, distinct views once; it does
    not read the fingerprints)."""
    from repro_torch.core.msj import run_msj
    from repro_torch.engine.comm import SimComm
    from repro_torch.kernels.msj_probe import ops

    probe_fn = probe_fn or ops.probe_bucketed
    seen = []

    def capture(*args, **kwargs):
        if not seen:
            copies = copy_inputs([*args, *kwargs.values()])
            seen.append(((tuple(copies[:len(args)]), dict(zip(kwargs, copies[len(args):]))),
                         distinct_bytes(args)))
        return probe_fn(*args, **kwargs)

    run_msj(db, sjs, SimComm(P), probe_fn=capture)
    return seen[0]


def table_split(args, reps: int = REPS) -> dict:
    """The hash join's three steps timed alone with CUDA events around each
    (mean of ``reps`` after one warm-up): the table fill, the table-build
    kernel and the table-probe kernel; and the table's size, its load
    (valid build rows / slots) and the slots the distinct rows took."""
    import torch

    from repro_torch.kernels.msj_probe import ops

    build, probe_side = tuple(args[:3]), tuple(args[3:])
    ops.check_join(build, probe_side)
    build_ok = build[2]
    slots = ops.table_slots(build_ok.shape[0])
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(reps + 1)]
    for ev in events:
        ev[0].record()
        table = torch.full((slots,), -1, dtype=torch.int32, device=DEVICE)
        ev[1].record()
        ops.table_build_cuda(table, *build)
        ev[2].record()
        ops.table_probe_cuda(table, build, probe_side)
        ev[3].record()
    torch.cuda.synchronize()

    def mean(k):
        return sum(ev[k].elapsed_time(ev[k + 1]) for ev in events[1:]) / reps

    return {"fill_ms": mean(0), "table_build_ms": mean(1), "table_probe_ms": mean(2),
            "table_slots": slots, "table_bytes": slots * 4,
            "table_load": int(build_ok.sum()) / slots,
            "table_rows": int((table >= 0).sum())}


def phase_kernel(main_case, in_bytes) -> dict:
    import torch

    from repro_torch.kernels.msj_probe import ops, ref

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    cases = kernel_cases(gen)
    cases["main_path_shard0"] = main_case
    checked, max_err = {}, 0
    for name, (args, kwargs) in cases.items():
        got = ops.probe_bucketed(*args, **kwargs)
        want = ops.probe_bucketed_plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if got.numel() else 0
        if not torch.equal(got, want) or err != 0:
            raise AssertionError(f"kernel != plain on case {name}: max |diff| {err}")
        max_err = max(max_err, err)
        if name != "main_path_shard0" and args[0].shape[0] * args[3].shape[0] <= 4e7:
            if not torch.equal(got, ref.probe(*args)):
                raise AssertionError(f"kernel != dense oracle on case {name}")
        checked[name] = {"np": int(args[3].shape[0]), "nb": int(args[0].shape[0]),
                         "kw": int(args[1].shape[1]), "hits": int(got.sum())}
    emit({"phase": "kernel_check", "cases": checked, "max_abs_err": max_err})

    # timing at the main path's shape
    args, kwargs = main_case
    ms = cuda_ms(lambda: ops.probe_bucketed(*args, **kwargs), REPS)
    plain_ms = cuda_ms(lambda: ops.probe_bucketed_plain(*args, **kwargs), REPS // 5)
    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok = args
    timing = {
        "np": int(probe_sig.shape[0]), "nb": int(build_sig.shape[0]), "kw": int(build_keys.shape[1]),
        "valid_probe": int(probe_ok.sum()), "valid_build": int(build_ok.sum()),
        "max_abs_err": max_err, "ms": ms, **table_split(args),
        "plain_ms": plain_ms, "library_ms": isin_ms(args),
        # the function's bytes: inputs read once, one bool out per probe row
        **bound(in_bytes, probe_sig.shape[0], 0),
    }
    emit({"phase": "kernel_timing", **timing})
    return timing


def isin_ms(args):
    """``torch.isin`` on (sig, key) packed into int64 (KW == 1 only): the
    one-call yardstick of the probes."""
    import torch

    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok = args
    if build_keys.shape[1] != 1:
        return None

    def packed(sig, keys, ok):
        v = (sig.to(torch.int64) << 32) | (keys[:, 0].to(torch.int64) & 0xFFFFFFFF)
        return v[ok]

    bp, pp = packed(build_sig, build_keys, build_ok), packed(probe_sig, probe_keys, probe_ok)
    return cuda_ms(lambda: torch.isin(pp, bp), REPS)


def phase_costmodel(main_case) -> dict:
    """The hash-join kernel and the torch sort-merge probe timed on the card
    at a small shard (2**COSTMODEL_SMALL_LOG2 rows a side) and at the main
    path's shard, beside the cost model's prices and choice there.  At each
    size, the kernel's row weight (``KERNEL_ROW_WEIGHT``) for which
    cost_kernel / cost_sorted equals the measured time ratio; the model
    takes their geometric mean."""
    import torch

    from repro_torch.core import costmodel, msj
    from repro_torch.kernels.msj_probe import ops

    n = 2**COSTMODEL_SMALL_LOG2
    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    sizes = {"small": probe_case(gen, n, n, 1, -n, n), "main": main_case}
    line, weights = {"phase": "costmodel"}, []
    for name, (args, kwargs) in sizes.items():
        nb, np_, kw = int(args[0].shape[0]), int(args[3].shape[0]), int(args[1].shape[1])
        if not torch.equal(ops.probe_bucketed(*args, **kwargs), msj.probe_sorted(*args, **kwargs)):
            raise AssertionError(f"costmodel {name}: kernel and sort-merge probes differ")
        t_kernel = cuda_ms(lambda: ops.probe_bucketed(*args, **kwargs), REPS)
        t_sorted = cuda_ms(lambda: msj.probe_sorted(*args, **kwargs), REPS // 4)
        c_sorted = costmodel.cost_sorted(nb, np_, kw)
        weights.append(c_sorted * t_kernel / t_sorted / ((kw + 1) * (nb + np_)))
        line[name] = {
            "nb": nb, "np": np_, "kw": kw, "kernel_ms": t_kernel, "sorted_ms": t_sorted,
            "cost_kernel": costmodel.cost_kernel(nb, np_, kw), "cost_sorted": c_sorted,
            "choice": costmodel.choose_backend(nb, np_, kw, on_cuda=True),
            "faster": "kernel" if t_kernel < t_sorted else "sorted",
            "row_weight": weights[-1],
        }
    line["fit"] = {"KERNEL_ROW_WEIGHT": math.sqrt(weights[0] * weights[1]),
                   "in_costmodel": costmodel.KERNEL_ROW_WEIGHT}
    emit(line)
    return line


# --------------------------------------------------------------------------
# phase 4: end to end
# --------------------------------------------------------------------------


def run_plan(db, plan, P, backend, tracer=None, bloom_bits=0):
    import torch

    from repro_torch.core.executor import Executor, ExecutorConfig
    from repro_torch.engine.comm import SimComm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = ExecutorConfig(probe_backend=backend, bloom_bits=bloom_bits)
    ex = Executor(dict(db), SimComm(P), cfg, tracer=tracer)
    env, report = ex.execute(plan)
    torch.cuda.synchronize()
    return env, report, time.perf_counter() - t0


def phase_seconds(report) -> dict:
    """Seconds per traced phase name, summed over the report's jobs."""
    out: dict[str, float] = {}
    for rec in report.records:
        for top in rec.spans:
            for sp in top.walk():
                if sp.cat == "phase":
                    out[sp.name] = out.get(sp.name, 0.0) + sp.dur
    return out


def same_outputs(env_a, env_b, names, what="auto and sorted backends") -> None:
    import torch

    for k in names:
        if not (torch.equal(env_a[k].data, env_b[k].data)
                and torch.equal(env_a[k].valid, env_b[k].valid)):
            raise AssertionError(f"{what} differ on {k}")


def msj_stat(report, key) -> list:
    from repro_torch.core.planner import MSJJob

    return [r.stats.get(key) for r in report.records if isinstance(r.job, MSJJob)]


def check_path_kernels(name, report, launches, bloom=False, backend="kernel") -> list:
    """Every MSJ job of ``report`` that ran (an original or a speculative
    clone, won or cancelled; not a failed or tainted unit) ran ``backend``
    (a list: the backend of each such job in record order); where one ran
    the kernel, every kernel of the path (the bloom kernels too with
    ``bloom``) launched, and the probe wrapper's count is its two kernels'.
    Returns the MSJ jobs' backends."""
    from repro_torch.core.planner import MSJJob

    backends = [r.backend for r in report.records
                if isinstance(r.job, MSJJob) and r.outcome in ("ok", "cancelled")]
    want = [backend] * len(backends) if isinstance(backend, str) else list(backend)
    if not backends or backends != want:
        raise AssertionError(f"{name}: MSJ jobs ran {backends}, not {want}")
    if "kernel" not in want:
        return backends
    idle = [k for k in ("probe_bucketed", "table_build", "table_probe")
            + (("bloom_build", "bloom_pack", "bloom_probe") if bloom else ())
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"{name}: kernels of the path never launched: {idle}")
    check_probe_launches(name, launches, "probe_bucketed")
    return backends


def phase_e2e(name, db, plan, P, rows, bloom_bits=0, keep=None) -> dict:
    import torch

    from repro_torch.core.planner import job_writes

    outputs = sorted(set().union(*(job_writes(j) for r in plan.rounds for j in r.jobs)))
    run_plan(db, plan, P, "auto", bloom_bits=bloom_bits)  # warm
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    env_a, rep_a, wall_a = run_plan(db, plan, P, "auto", bloom_bits=bloom_bits)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    msj_backends = check_path_kernels(name, rep_a, launches, bool(bloom_bits))
    # the sorted reference path: compare the measured auto run's outputs
    # first, then free them before the sorted runs
    run_plan(db, plan, P, "sorted", bloom_bits=bloom_bits)  # warm
    env_s, rep_s, wall_s = run_plan(db, plan, P, "sorted", bloom_bits=bloom_bits)
    same_outputs(env_a, env_s, outputs)
    stats_a = [r.stats for r in rep_a.records]
    if stats_a != [r.stats for r in rep_s.records]:
        raise AssertionError(f"{name}: auto and sorted counters differ")
    del env_s
    without = {}
    if bloom_bits:
        # the prefilter changes traffic, never results or the count-sized cap
        env_0, rep_0, wall_0 = run_plan(db, plan, P, "auto")
        same_outputs(env_a, env_0, outputs, "bloom and no-bloom runs")
        fwd, fwd_0 = msj_stat(rep_a, "bytes_fwd"), msj_stat(rep_0, "bytes_fwd")
        if any(a > b for a, b in zip(fwd, fwd_0)):
            raise AssertionError(f"{name}: the prefilter added forward bytes: {fwd} > {fwd_0}")
        if msj_stat(rep_a, "forward_cap") != msj_stat(rep_0, "forward_cap"):
            raise AssertionError(f"{name}: the prefilter changed the forward capacity")
        without = {"wall_no_bloom_s": wall_0, "bytes_shuffled_no_bloom": rep_0.bytes_shuffled(),
                   "bytes_fwd": fwd, "bytes_fwd_no_bloom": fwd_0,
                   "sent_fwd": msj_stat(rep_a, "sent_fwd"),
                   "sent_fwd_no_bloom": msj_stat(rep_0, "sent_fwd")}
        del env_0
    out_rows = {k: int(env_a[k].count()) for k in outputs}
    if keep is not None:  # the executor phase holds its runs to this one
        keep.update(env={k: env_a[k] for k in outputs}, stats=stats_by_job(rep_a))
    del env_a
    from repro_torch.obs.tracer import Tracer

    _, rep_t, wall_t = run_plan(db, plan, P, "auto", tracer=Tracer(trace_sync=True),
                                bloom_bits=bloom_bits)
    result = {
        "phase": "e2e", "plan": name, "rows_per_relation": rows, "P": P,
        "bloom_bits": bloom_bits, "probe_wrapper": "probe_bucketed", "jobs": rep_a.n_jobs,
        "msj_backends": msj_backends,
        "launches": launches, "wall_auto_s": wall_a, "wall_sorted_s": wall_s,
        "bytes_shuffled": rep_a.bytes_shuffled(), **without,
        "forward_cap": [r.stats.get("forward_cap") for r in rep_a.records],
        "output_rows": out_rows, "peak_mem_bytes": peak, "bit_identical": True,
        "traced_wall_s": wall_t, "phase_s": phase_seconds(rep_t),
    }
    emit(result)
    return result


# --------------------------------------------------------------------------
# phase 5: the bloom prefilter's kernels
# --------------------------------------------------------------------------


def capture_bloom_inputs(db, sjs, P, bits):
    """Shard 0's inputs of the bloom wrappers from one MSJ run with the
    prefilter, as ``run_msj`` passes them: ``(build_in, probe_in)`` with
    ``build_in = (keys, sigs, mask, fp)`` of the build and ``probe_in =
    (recv_words, keys, sig, fp)`` of the pack and the first packed probe
    (copied with their aliasing; the signature stays a stride-0 view)."""
    import types

    import torch

    from repro_torch.core import msj
    from repro_torch.engine.comm import SimComm
    from repro_torch.kernels.bloom import ops as bloom_ops
    from repro_torch.kernels.msj_probe import ops

    real = {name: getattr(bloom_ops, name) for name in ("build", "pack", "probe_packed")}
    seen = {}

    def recording(name):
        def call(*a, **kw):
            if name not in seen:
                args = (*a, *kw.values())
                copies = iter(copy_inputs([x for x in args if torch.is_tensor(x)]))
                seen[name] = tuple(next(copies) if torch.is_tensor(x) else x for x in args)
            return real[name](*a, **kw)
        return call

    # run_msj reaches the wrappers through its module's ``bloom_ops``: stand
    # that in, so the wrappers and their counters stay as they are
    msj.bloom_ops = types.SimpleNamespace(**{name: recording(name) for name in real})
    try:
        msj.run_msj(db, sjs, SimComm(P), bloom_bits=bits, probe_fn=ops.probe_bucketed)
    finally:
        msj.bloom_ops = bloom_ops
    keys, sigs, mask, b, fp = seen["build"]
    _, pkeys, psig, b2, pfp = seen["probe_packed"]
    assert b == b2 == bits
    return (keys, sigs, mask, fp), (seen["pack"][0], pkeys, psig, pfp)


def bloom_rows(gen, n, kw=1, fp=False, sig_range=4):
    """``(keys, sigs, mask, fp)`` on the card: random int32 keys, fp the
    first key column or None."""
    import torch

    keys = torch.randint(-(2**31), 2**31, (n, kw), generator=gen, dtype=torch.int64,
                         device=DEVICE).to(torch.int32)
    sigs = torch.randint(0, sig_range, (n,), generator=gen, device=DEVICE).to(torch.int32)
    mask = torch.rand(n, generator=gen, device=DEVICE) < 0.6
    return keys, sigs, mask, (keys[:, 0] if fp else None)


def bloom_cases(gen) -> dict:
    """``name -> ((keys, sigs, mask, fp), bits)`` on the card: bits 128 to
    2**24 (384 and 1000 not powers of two of 128 words); 0, 1 and ragged
    row counts; KW = 2 views of one buffer with a stride-0 signature; all
    rows inactive; every row the same; rows picked because a position of
    theirs is the last bit or bit 31 of a word."""
    import torch

    from repro_torch.kernels.bloom import ops as bloom_ops

    cases = {}
    for bits in (128, 384, 1000, 2**16, 2**20, 2**24):
        for n in (0, 1, 1000, 70_001):
            cases[f"bits{bits}_n{n}"] = (bloom_rows(gen, n, fp=n % 2 == 1), bits)
    n, bits = 50_000, 2**16
    flat = bloom_rows(gen, n, kw=4)[0]
    sig0 = torch.full((1,), 2, dtype=torch.int32, device=DEVICE).expand(n)
    mask = torch.rand(n, generator=gen, device=DEVICE) < 0.5
    cases["kw2_views_stride0_sig"] = ((flat[:, 1:3], sig0, mask, None), bits)
    cases["fp_view_stride0_sig"] = ((flat[:, 1:3], sig0, mask, flat[:, 3]), bits)
    keys, sigs, mask, _ = bloom_rows(gen, n)
    cases["all_inactive"] = ((keys, sigs, torch.zeros_like(mask), None), bits)
    cases["one_row_many_times"] = ((keys[:1].expand(n, 1).contiguous(), sigs[:1].expand(n)
                                    .contiguous(), torch.ones_like(mask), None), bits)
    keys, sigs, mask, _ = bloom_rows(gen, 200_000, kw=2)
    pos = bloom_ops.positions(keys, sigs, 2**12)
    for name, hit in (("last_bit", pos == 2**12 - 1), ("bit31", (pos & 31) == 31)):
        rows = hit.any(1) | (torch.arange(pos.shape[0], device=DEVICE) % 50 == 0)
        cases[name] = ((keys[rows], sigs[rows], torch.ones_like(mask[rows]), None), 2**12)
    return cases


def max_diff(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def bloom_check(rows, bits) -> int:
    """The build, pack and probes on the card against their plain versions
    from ``positions``, exactly: the filter, ``probe`` of it, ``pack`` of a
    stack of it and a filter of every other active row (so the probe answers
    both ways) and ``probe_packed`` of that.  Returns the max |diff| (0 or
    it raises)."""
    import torch

    from repro_torch.kernels.bloom import ops as bloom_ops

    keys, sigs, mask, fp = rows
    half = mask & (torch.arange(mask.shape[0], device=DEVICE) % 2 == 0)
    nw = bloom_ops.n_words(bits)
    got = {"filt": bloom_ops.build(keys, sigs, mask, bits, fp=fp),
           "half": bloom_ops.build(keys, sigs, half, bits, fp=fp)}
    got["found"] = bloom_ops.probe(got["half"], keys, sigs, bits, fp=fp)
    stack = torch.stack([got["half"], got["filt"]])
    got["packed"] = bloom_ops.pack(stack)
    got["packed_half"] = bloom_ops.pack(got["half"])
    got["found_packed"] = bloom_ops.probe_packed(got["packed_half"], keys, sigs, bits, fp=fp)
    got["found_all"] = bloom_ops.probe_packed(got["packed"], keys, sigs, bits, fp=fp)
    torch.cuda.synchronize()
    pos = bloom_ops.positions(keys, sigs, bits, fp=fp)
    want = {"filt": bloom_ops.build_plain(pos, mask, nw),
            "half": bloom_ops.build_plain(pos, half, nw)}
    want["found"] = bloom_ops.probe_plain(pos, want["half"])
    want["packed"] = bloom_ops.pack_plain(torch.stack([want["half"], want["filt"]]))
    want["packed_half"] = bloom_ops.pack_plain(want["half"])
    want["found_packed"] = want["found"]
    want["found_all"] = bloom_ops.probe_packed_plain(want["packed"], pos)
    err = max(max_diff(got[k], want[k]) for k in want)
    if err or not all(torch.equal(got[k], want[k]) for k in want):
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        raise AssertionError(f"bloom kernels != plain on {bad}: max |diff| {err}")
    if not (bool(got["found"][half].all()) and bool(got["found_all"][mask].all())):
        raise AssertionError("bloom probe kernel: a false negative")
    return err


def hash_ops(n, kw, fp) -> int:
    """Integer operations of ``positions`` for n rows, from the kernel's
    source: mix32 is 8 (three shifts, three xors, two multiplies); with fp,
    mix32(sig), one xor and per probe an xor, a mix32 and a modulo; without,
    per probe and column (the signature first) two shifts, three adds, an
    xor and a mix32, and a modulo; then per probe the word index, the bit
    mask and the bit operation (3)."""
    per_probe = 10 if fp else 14 * (kw + 1) + 1
    return n * ((9 if fp else 0) + 2 * (per_probe + 3))


def pack_bound(recv) -> dict:
    """pack: the stack read once, the packed bitset written once; a max and
    a compare per source and bit."""
    s, nw, lanes = recv.shape
    return bound(s * nw * lanes * 4, nw * lanes // 8, 2 * s * nw * lanes)


def probe_bound(keys, sig, fp, words_read) -> dict:
    """probe: the key or fp column and the signature (each distinct view
    once), the distinct packed words it tests, one byte out per row."""
    col = keys if fp is None else fp
    n = sig.shape[0]
    return bound(distinct_bytes([col, sig]) + 4 * words_read, n,
                 hash_ops(n, keys.shape[1], fp is not None))


def build_bound(keys, sigs, mask, fp, nbits) -> dict:
    """build: 9 bytes per row (a key or fp word, the signature, the mask
    byte) read once, the int32 filter written once."""
    col = keys if fp is None else fp
    return bound(distinct_bytes([col, sigs, mask]), nbits * 4,
                 hash_ops(sigs.shape[0], keys.shape[1], fp is not None))


def kernel_ms(fn, reps: int = REPS) -> float:
    """Device time of ``fn`` alone: CUDA events around each call, mean of
    ``reps`` after one warm-up.  The calls queue up behind a ~5 ms spin of
    the card, so the card does not wait for the host between them."""
    import torch

    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(10_000_000)
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def phase_bloom_kernels(build_in, probe_in, bits) -> dict:
    import torch

    from repro_torch.kernels.bloom import ops as bloom_ops

    gen = torch.Generator(device=DEVICE).manual_seed(2345)
    cases = bloom_cases(gen)
    cases["main_path_shard0"] = (build_in, bits)
    checked, max_err = {}, 0
    for name, (rows, b) in cases.items():
        max_err = max(max_err, bloom_check(rows, b))
        checked[name] = {"n": int(rows[1].shape[0]), "kw": int(rows[0].shape[1]),
                         "bits": bloom_ops.n_words(b) * bloom_ops.LANES,
                         "fp": rows[3] is not None, "active": int(rows[2].sum())}
    # the pack and the first probe on their own main-path inputs, against
    # the plain versions and the parent's path (amax, then a gather)
    recv, keys, sig, fp = probe_in
    packed = bloom_ops.pack(recv)
    found = bloom_ops.probe_packed(packed, keys, sig, bits, fp=fp)
    pos = bloom_ops.positions(keys, sig, bits, fp=fp)
    want_packed = bloom_ops.pack_plain(recv)
    want_found = bloom_ops.probe_packed_plain(want_packed, pos)
    err = max(max_diff(packed, want_packed), max_diff(found, want_found))
    if err or not torch.equal(found, bloom_ops.probe_plain(pos, recv.amax(dim=0))):
        raise AssertionError(f"bloom pack / probe != plain on the main-path inputs: {err}")
    emit({"phase": "bloom_check", "cases": checked, "max_abs_err": max_err})

    keys_b, sigs_b, mask_b, fp_b = build_in
    nw = bloom_ops.n_words(bits)
    nbits = nw * bloom_ops.LANES
    # the yardsticks' inputs (int64 indices, the OR-ed filter), made once
    pos_b = bloom_ops.positions(keys_b, sigs_b, bits, fp=fp_b)
    active_idx = pos_b[mask_b].reshape(-1).long()
    filt_or = recv.amax(dim=0)
    flat, pos_idx = filt_or.reshape(-1), pos.long()
    scratch = torch.empty((nbits // 32,), dtype=torch.int32, device=DEVICE)
    out = torch.empty((nw, bloom_ops.LANES), dtype=torch.int32, device=DEVICE)
    build_args = bloom_ops._rows("build", keys_b, sigs_b, fp_b, ())
    cap = sig.shape[0]
    sig_of_sj = sig[:1].clone()

    def build_entry():  # the one entry point alone, on buffers made once
        bloom_ops._launch(bloom_ops.build, 0, None, sigs_b.device, *build_args,
                          mask_b.data_ptr(), sigs_b.shape[0], nbits, scratch.data_ptr(),
                          out.data_ptr())

    def probe_as_msj():  # stage_map: the stride-0 signature view, then the probe
        return bloom_ops.probe_packed(packed, keys, sig_of_sj[0:1].expand(cap), bits, fp=fp)

    build_t = {
        "n": int(sigs_b.shape[0]), "kw": int(keys_b.shape[1]), "fp": fp_b is not None,
        "active": int(mask_b.sum()), "bits": nbits,
        "bits_set": int(bloom_ops.build(keys_b, sigs_b, mask_b, bits, fp=fp_b).sum()),
        "max_abs_err": max_err,
        "ms": kernel_ms(build_entry),
        "wrapper_ms": cuda_ms(lambda: bloom_ops.build(keys_b, sigs_b, mask_b, bits, fp=fp_b),
                              REPS),
        "plain_ms": cuda_ms(lambda: bloom_ops.build_plain(
            bloom_ops.positions(keys_b, sigs_b, bits, fp=fp_b), mask_b, nw), REPS // 5),
        "library_ms": cuda_ms(lambda: torch.zeros(nbits, dtype=torch.int32, device=DEVICE)
                              .scatter_(0, active_idx, 1), REPS),
        **build_bound(keys_b, sigs_b, mask_b, fp_b, nbits),
    }
    pack_t = {
        "sources": int(recv.shape[0]), "bits": nbits, "max_abs_err": max(max_err, err),
        "ms": kernel_ms(lambda: bloom_ops.pack(recv)),
        "wrapper_ms": cuda_ms(lambda: bloom_ops.pack(recv), REPS),
        "plain_ms": cuda_ms(lambda: bloom_ops.pack_plain(recv), REPS // 5),
        "library_ms": cuda_ms(lambda: recv.amax(dim=0), REPS),
        **pack_bound(recv),
    }
    probe_t = {
        "n": int(cap), "kw": int(keys.shape[1]), "fp": fp is not None, "bits": nbits,
        "max_abs_err": max(max_err, err), "bits_set": int((filt_or > 0).sum()),
        "found": int(found.sum()),
        "ms": kernel_ms(lambda: bloom_ops.probe_packed(packed, keys, sig, bits, fp=fp)),
        "wrapper_ms": cuda_ms(probe_as_msj, REPS),
        "plain_ms": cuda_ms(lambda: bloom_ops.probe_packed_plain(
            packed, bloom_ops.positions(keys, sig, bits, fp=fp)), REPS // 5),
        # a gather of the OR-ed int32 filter at positions made beforehand
        "library_ms": cuda_ms(lambda: torch.take(flat, pos_idx).all(1), REPS),
        **probe_bound(keys, sig, fp, int(torch.unique(pos >> 5).numel())),
    }
    emit({"phase": "bloom_timing", "build": build_t, "pack": pack_t, "probe": probe_t})
    return {"bloom_build": build_t, "bloom_pack": pack_t, "bloom_probe": probe_t}


def load_bloom_ops(tree: Path):
    """The bloom ops module of another checkout of the port (its kernels
    built from its own ``bloom.cu``), imported beside this one's."""
    import importlib.util

    path = tree / "src" / "repro_torch" / "kernels" / "bloom" / "ops.py"
    spec = importlib.util.spec_from_file_location("compared_bloom_ops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_bloom_compare(tree: Path, build_in, probe_in, bits, timings) -> dict:
    """The bloom wrappers of this tree and of ``tree`` as ``run_msj`` calls
    them, on shard 0's main-path inputs, in turns (other, this, this,
    other): the build; per shard what turns the received stack into the
    filter the probes read (``amax`` before the packed bitset, ``pack``
    since); per semi-join the signature column and the probe.  Each time
    beside this tree's bound of the same work."""
    import torch

    from repro_torch.kernels.bloom import ops as this

    other = load_bloom_ops(tree)
    keys_b, sigs_b, mask_b, fp_b = build_in
    recv, keys, sig, fp = probe_in
    cap, sig_id = sig.shape[0], int(sig[0])

    sig_of_sj = sig[:1].clone()

    def wrappers(mod):
        if hasattr(mod, "pack"):
            shard = mod.pack(recv)
            def probe():
                return mod.probe_packed(shard, keys, sig_of_sj[0:1].expand(cap), bits, fp=fp)
            per_shard = lambda: mod.pack(recv)  # noqa: E731
        else:
            shard = recv.amax(dim=0)
            def probe():
                s = torch.full((cap,), sig_id, dtype=torch.int32, device=DEVICE)
                return mod.probe(shard, keys, s, bits, fp=fp)
            per_shard = lambda: recv.amax(dim=0)  # noqa: E731
        return {"build": lambda: mod.build(keys_b, sigs_b, mask_b, bits, fp=fp_b),
                "per_shard": per_shard, "probe": probe}

    runs = {"other": wrappers(other), "this": wrappers(this)}
    for name in ("build", "probe"):
        a, b = runs["other"][name](), runs["this"][name]()
        if not torch.equal(a, b):
            raise AssertionError(f"bloom {name}: this tree and {tree} differ")
    result = {"phase": "bloom_compare", "tree": str(tree)}
    bounds = {"build": timings["bloom_build"], "per_shard": timings["bloom_pack"],
              "probe": timings["bloom_probe"]}
    for name in ("build", "per_shard", "probe"):
        ms = {}
        for label in ("other", "this", "this", "other"):
            ms.setdefault(label, []).append(cuda_ms(runs[label][name], REPS))
        result[name] = {"other_ms": ms["other"], "this_ms": ms["this"],
                        "bound_ms": bounds[name]["bound_ms"]}
    emit(result)
    return result


# --------------------------------------------------------------------------
# phase 6: the unbucketed all-pairs probe
# --------------------------------------------------------------------------


def phase_blocked(db, sjs, P, rows):
    import torch

    from repro_torch.core.msj import probe_sorted, run_msj
    from repro_torch.engine.comm import SimComm
    from repro_torch.kernels.msj_probe import ops, ref

    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    cases = kernel_cases(gen)
    main_case, in_bytes = capture_main_path_probe(db, sjs, P, probe_fn=ops.probe)
    cases["main_path_shard0"] = main_case
    checked, max_err = {}, 0
    for name, (args, kwargs) in cases.items():
        got = ops.probe(*args, **kwargs)
        want = ops.probe_blocked_plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if got.numel() else 0
        if not torch.equal(got, want) or err != 0:
            raise AssertionError(f"blocked kernel != plain on case {name}: max |diff| {err}")
        max_err = max(max_err, err)
        if name != "main_path_shard0" and args[0].shape[0] * args[3].shape[0] <= 4e7:
            if not torch.equal(got, ref.probe(*args)):
                raise AssertionError(f"blocked kernel != dense oracle on case {name}")
        checked[name] = {"np": int(args[3].shape[0]), "nb": int(args[0].shape[0]),
                         "kw": int(args[1].shape[1]), "hits": int(got.sum())}
    emit({"phase": "blocked_check", "cases": checked, "max_abs_err": max_err})

    args, kwargs = main_case
    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok = args
    n_valid_p, n_valid_b = int(probe_ok.sum()), int(build_ok.sum())
    timing = {
        "np": int(probe_sig.shape[0]), "nb": int(build_sig.shape[0]),
        "kw": int(build_keys.shape[1]), "valid_probe": n_valid_p, "valid_build": n_valid_b,
        "max_abs_err": max_err,
        "ms": cuda_ms(lambda: ops.probe(*args, **kwargs), REPS),
        **table_split(args),
        "plain_ms": cuda_ms(lambda: ops.probe_blocked_plain(*args, **kwargs), 2),
        "library_ms": isin_ms(args),
        # the plain version's work, not part of the bound
        "all_pairs": n_valid_p * n_valid_b,
        # inputs read once, one bool out per probe row
        **bound(in_bytes, probe_sig.shape[0], 0),
    }
    emit({"phase": "blocked_timing", **timing})
    del main_case, args, kwargs, cases

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out_b, st_b = run_msj(db, sjs, SimComm(P), probe_fn=ops.probe)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches["probe_blocked"] <= 0:
        raise AssertionError("blocked_probe: the all-pairs kernel was never launched")
    check_probe_launches("blocked_probe", launches, "probe_blocked")
    runs, walls = {"all-pairs": (out_b, st_b)}, {}
    for label, fn in (("bucketed", ops.probe_bucketed), ("sorted", probe_sorted)):
        t0 = time.perf_counter()
        runs[label] = run_msj(db, sjs, SimComm(P), probe_fn=fn)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
    # the witness: the sort-merge probe shares no code with the hash join
    out_s, st_s = runs.pop("sorted")
    stats = {k: int(v) for k, v in st_s.items()}
    for label, (out, st) in runs.items():
        same_outputs(out, out_s, sorted(out_s), f"{label} and sorted probes")
        if {k: int(v) for k, v in st.items()} != stats:
            raise AssertionError(f"blocked_probe: {label} and sorted counters differ")
    result = {"phase": "e2e", "plan": "blocked_probe", "rows_per_relation": rows, "P": P,
              "probe_wrapper": "probe_blocked", "launches": launches, "wall_blocked_s": wall_b,
              "wall_bucketed_s": walls["bucketed"], "wall_sorted_s": walls["sorted"],
              "peak_mem_bytes": peak, "stats": stats, "bit_identical": True}
    emit(result)
    return timing, result


# --------------------------------------------------------------------------
# phase: the executor's fault-tolerant scheduling
# --------------------------------------------------------------------------

EXECUTOR_LOG2_ROWS = 22  # rows per relation of the executor phase's parts (b)-(e)
EXECUTOR_ORACLE_ROWS = 2**8  # rows per relation of part (d)'s plan run on the CPU
STRAGGLE = 30.0  # wall scale of the injected straggler's first attempt
XYZW = ("x", "y", "z", "w")


def in_background(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, started now on a host thread of its own
    (numpy draws and set operations, which release the GIL while they
    run); the returned future's ``result()`` waits for it."""
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(fn, *args, **kwargs)
    finally:
        pool.shutdown(wait=False)


def measured(fn):
    """``fn()`` with every launch counter from 0 and the peak reset:
    ``(result, {"seconds", "launches", "peak_mem_bytes"})``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"seconds": time.perf_counter() - t0, "launches": read_counts(),
                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def stats_by_job(report) -> dict:
    """Each completed job's counters, by job (the async walk orders jobs by
    measured walls, the waves by modeled cost)."""
    return {repr(r.job): r.stats for r in report.records if r.outcome == "ok"}


def check_timeline(name, plan, log, slots, edges="relations") -> None:
    """No dispatch starts before its predecessors end (under the DAG of
    ``edges``), and at most ``slots`` slots are used."""
    from repro_torch.core.planner import job_dag

    by_idx = {s.idx: s for s in log if s.attempt == 0}
    for n in job_dag(plan, edges):
        late = [d for d in n.deps if by_idx[d].end > by_idx[n.idx].start]
        if late:
            raise AssertionError(f"{name}: job {n.idx} starts before {late} end")
    if slots is not None and len({s.slot for s in log}) > slots:
        raise AssertionError(f"{name}: {len({s.slot for s in log})} slots used, {slots} allowed")


def plan_outputs(plan) -> list:
    from repro_torch.core.planner import job_writes

    return sorted(set().union(*(job_writes(j) for r in plan.rounds for j in r.jobs)))


def executor_waves(gdb, plan, P, greedy) -> dict:
    """(a) The GREEDY plan as barrier waves (unbounded, then two slots) and
    as the async walk on two slots: outputs and every job's counters equal
    to the ``e2e`` ``greedy`` run's (the async walk, unbounded)."""
    from repro_torch.core.executor import Executor, ExecutorConfig
    from repro_torch.engine.comm import SimComm

    runs = {}
    for label, mode, slots in (("waves", "waves", None), ("waves_2", "waves", 2),
                               ("async_2", "async", 2)):
        name = f"executor waves {label}"
        ex = Executor(dict(gdb), SimComm(P), ExecutorConfig(execution_mode=mode))
        (env, rep), run = measured(lambda: ex.execute(plan, slots=slots))
        check_path_kernels(name, rep, run["launches"])
        check_timeline(name, plan, ex.schedule, slots)
        same_outputs(greedy["env"], env, sorted(greedy["env"]), f"the e2e greedy run and {name}")
        if stats_by_job(rep) != greedy["stats"]:
            raise AssertionError(f"{name}: job counters differ from the e2e greedy run")
        if slots is None and mode == "waves":
            starts = {}
            for r in rep.records:
                starts.setdefault(r.round_idx, set()).add(r.start)
            if any(len(s) != 1 for s in starts.values()):
                raise AssertionError(f"{name}: a round's jobs do not start at one barrier")
        runs[label] = {**run, "jobs": rep.n_jobs, "slots_used": len({s.slot for s in ex.schedule}),
                       "makespan_s": rep.event_makespan()}
        del env, rep, ex
    return {"part": "waves", "plan": "greedy", "runs": runs}


def executor_db(P, seed, rows) -> dict:
    """One database for parts (b), (d) and (e), drawn and placed in shards
    on the host (on a thread of its own, beside part (a)): the base
    relations of C4, A4 and the three poison tenants."""
    from repro_torch.core import queries
    from repro_torch.core.relation import db_from_dict

    qs = (list(queries.make_sgf("C4").queries) + queries.make_queries("A4")
          + poison_tenants())
    return db_from_dict(queries.gen_db(qs, n_guard=rows, n_cond=rows, seed=seed), P=P,
                        device="cpu")


def executor_edges(db, P) -> dict:
    """(b) C4 planned ``parunit``: relation edges, strata edges, and relation
    edges on the sort-merge probe (a control sharing no code with the hash
    join), two slots each, bit-identical."""
    from repro_torch.core import queries
    from repro_torch.core.executor import Executor, ExecutorConfig
    from repro_torch.core.planner import plan_sgf
    from repro_torch.engine.comm import SimComm

    sgf = queries.make_sgf("C4")
    plan = plan_sgf(sgf, "parunit")
    names = plan_outputs(plan)
    runs, base = {}, None
    for label, edges, backend in (("relations", "relations", "auto"),
                                  ("strata", "strata", "auto"),
                                  ("relations_sorted", "relations", "sorted")):
        name = f"executor edges {label}"
        ex = Executor(dict(db), SimComm(P), ExecutorConfig(dag_edges=edges, probe_backend=backend))
        (env, rep), run = measured(lambda: ex.execute(plan, slots=2))
        check_path_kernels(name, rep, run["launches"],
                           backend="kernel" if backend == "auto" else backend)
        check_timeline(name, plan, ex.schedule, 2, edges)
        if base is None:
            base = ({k: env[k] for k in names}, stats_by_job(rep))
        else:
            same_outputs(base[0], env, names, f"executor edges relations and {label}")
            if stats_by_job(rep) != base[1]:
                raise AssertionError(f"{name}: job counters differ from the relations run")
        runs[label] = {**run, "jobs": rep.n_jobs, "makespan_s": rep.event_makespan()}
        del env, rep, ex
    return {"part": "edges", "plan": "C4 parunit", "runs": runs,
            "output_rows": {k: int(base[0][k].count()) for k in names}}


def star_scenario(n_rows, seed, n_jobs=6):
    """The reference's ``_fused_star_scenario`` (``tests/test_speculation.py``)
    at ``n_rows`` rows per relation: one round of ``n_jobs`` fused
    one-equation MSJ jobs over distinct arity-4 guards, each semi-joined
    with one unary ``S``; values drawn from ``[0, n_rows / 2)``, as the
    reference's 128 rows from ``[0, 64)``."""
    import numpy as np

    from repro_torch.core.algebra import BSGF, Atom, all_of
    from repro_torch.core.planner import MSJJob, Plan, Round, pooled_semijoins

    rng = np.random.default_rng(seed)
    hi = max(n_rows // 2, 1)
    qs, db_np = [], {}
    for i in range(n_jobs):
        qs.append(BSGF(f"Z{i}", XYZW, Atom(f"G{i}", *XYZW), all_of(Atom("S", "x"))))
        db_np[f"G{i}"] = rng.integers(0, hi, (n_rows, 4)).astype(np.int32)
    db_np["S"] = rng.integers(0, hi, (n_rows, 1)).astype(np.int32)
    jobs = [MSJJob(tuple(pooled_semijoins([q])[0]), fused=(q,)) for q in qs]
    return qs, db_np, Plan((Round(tuple(jobs)),)), jobs


class DeadlineLog:
    """Records every speculation deadline the executor computes (the
    calibration's median ratio, the job's modeled cost, the deadline), by
    wrapping ``costmodel.speculation_deadline`` where the executor calls it."""

    def __init__(self):
        import repro_torch.core.executor as executor

        self.module, self.rows = executor, []

    def __enter__(self):
        wrapped = self.module.speculation_deadline

        def deadline(est_cost, *, scale, factor, slots):
            out = wrapped(est_cost, scale=scale, factor=factor, slots=slots)
            self.rows.append({"est": est_cost, "scale": scale,
                              "deadline_s": None if math.isinf(out) else out})
            return out

        self.wrapped = wrapped
        self.module.speculation_deadline = deadline
        return self

    def __exit__(self, *exc):
        self.module.speculation_deadline = self.wrapped


def wall_over_deadline(name, report, deadlines, straggler) -> dict:
    """Each original attempt's wall over the deadline the executor computed
    for it (one deadline per completed original, in the order of the
    records; a clone has none, and the first job of a run an unbounded
    one): the largest ratio among the jobs that do not straggle, and the
    straggler's (``straggler``: its job, or None)."""
    originals = [r for r in report.records if not r.speculative]
    if len(originals) != len(deadlines):
        raise AssertionError(f"{name}: {len(originals)} original attempts, "
                             f"{len(deadlines)} deadlines")
    others, mine = [], None
    for r, d in zip(originals, deadlines):
        if d["deadline_s"] is None:
            continue
        if r.job is straggler:
            mine = r.wall / d["deadline_s"]
        else:
            others.append(r.wall / d["deadline_s"])
    return {"max_other": max(others, default=None), "straggler": mine}


def executor_speculate(P, seed, rows) -> dict:
    """(c) Speculative re-dispatch on real walls: the star's last job
    straggles 30x on its first attempt, two slots."""
    from repro_torch.core.costmodel import stats_of_db
    from repro_torch.core.executor import Executor, ExecutorConfig, TransientFault
    from repro_torch.core.relation import db_from_dict
    from repro_torch.engine.comm import SimComm
    from repro_torch.service.scheduler import SlotScheduler

    qs, db_np, plan, jobs = star_scenario(rows, seed)
    db = db_from_dict(db_np, P=P)
    stats = stats_of_db(db)
    target, names = jobs[-1], [q.name for q in qs]

    def straggle(job, attempt):
        return STRAGGLE if job is target and attempt == 0 else 1.0

    def run_with(label, config, *, executor=Executor, on_job=None, wall_scale=straggle):
        name = f"executor speculate {label}"
        ex = executor(dict(db), SimComm(P), config)
        sched = SlotScheduler(ex, slots=2, stats=stats)
        with DeadlineLog() as log:
            (env, rep), run = measured(
                lambda: sched.execute(plan, on_job=on_job, wall_scale=wall_scale))
        check_path_kernels(name, rep, run["launches"], backend=(
            "kernel" if config.probe_backend == "auto" else config.probe_backend))
        run.update(jobs=rep.n_jobs, n_speculative=rep.n_speculative,
                   makespan_s=rep.event_makespan(),
                   wall_over_deadline=wall_over_deadline(
                       name, rep, log.rows, target if wall_scale is straggle else None),
                   records=[{"job": names[jobs.index(r.job)], "slot": r.slot, "start": r.start,
                             "wall": r.wall, "attempt": r.attempt, "outcome": r.outcome}
                            for r in rep.records],
                   deadlines=log.rows)
        return env, rep, ex, run

    # the first run builds nothing (the kernels are built) but warms the
    # allocator and the host paths, so no later wall carries a warm-up
    _, _, _, warm = run_with("warm", ExecutorConfig(), wall_scale=None)
    per_job, rem = divmod(warm["launches"]["probe_bucketed"], len(jobs))
    if rem or not per_job:
        raise AssertionError(f"executor speculate: {warm['launches']} over {len(jobs)} jobs")
    env_off, rep_off, _, off = run_with("off", ExecutorConfig())
    env_on, rep_on, _, on = run_with("on", ExecutorConfig(speculate=True))
    same_outputs(env_off, env_on, names, "speculation off and on")
    if rep_off.n_speculative != 0 or rep_on.n_speculative != 1:
        raise AssertionError(f"executor speculate: {rep_off.n_speculative} clones off, "
                             f"{rep_on.n_speculative} on (want 0 and 1): {on['records']} "
                             f"deadlines {on['deadlines']}")
    dup = [r for r in rep_on.records if r.job is target]
    winner = [r for r in dup if not r.cancelled]
    if len(dup) != 2 or len(winner) != 1 or not winner[0].speculative:
        raise AssertionError(f"executor speculate: the clone did not win: {on['records']}")
    if not rep_on.event_makespan() < rep_off.event_makespan():
        raise AssertionError(f"executor speculate: makespan {rep_on.event_makespan()} with "
                             f"speculation, {rep_off.event_makespan()} without")
    for label, run, n in (("off", off, len(jobs)), ("on", on, len(jobs) + 1)):
        if run["launches"]["probe_bucketed"] != n * per_job:
            raise AssertionError(f"executor speculate {label}: {run['launches']} for {n} jobs "
                                 f"at {per_job} launches each")
    del env_on, rep_on, rep_off
    env_s, rep_s, _, srt = run_with("sorted", ExecutorConfig(probe_backend="sorted"),
                                    wall_scale=None)
    same_outputs(env_off, env_s, names, "speculation and the sort-merge control")
    del env_s, rep_s

    calls = {"n": 0}

    def clone_dies(job, attempt):
        if job is target:
            calls["n"] += 1
            if calls["n"] > 1:
                raise TransientFault("clone dies")

    env_f, rep_f, _, dies = run_with("failing_clone", ExecutorConfig(speculate=True),
                                     on_job=clone_dies)
    if calls["n"] != 2 or rep_f.n_speculative != 0 or any(r.cancelled for r in rep_f.records):
        raise AssertionError(f"executor speculate failing_clone: {calls['n']} target attempts, "
                             f"{rep_f.n_speculative} clones: {dies['records']}")
    same_outputs(env_off, env_f, names, "speculation and a failing clone")
    del env_f, rep_f

    seen = []

    class Flaky(Executor):
        """The straggler's first attempt reports an overflow."""

        def run_job(self, job, *, cap_override=None, cap_slack=None):
            outs, st = super().run_job(job, cap_override=cap_override, cap_slack=cap_slack)
            if job is target:
                seen.append((cap_override, cap_slack))
                if len(seen) == 1:
                    st = dict(st, overflow=3, forward_cap=512)
            return outs, st

    config = ExecutorConfig(cap_slack=0.5, speculate=True)
    env_r, rep_r, ex_r, relax = run_with("relaxed_once", config, executor=Flaky)
    if seen != [(None, None), (None, 1.0), (None, 1.0)] or rep_r.n_speculative != 1:
        raise AssertionError(f"executor speculate relaxed_once: sizes {seen}, "
                             f"{rep_r.n_speculative} clones: {relax['records']}")
    if ex_r.config is not config or config != ExecutorConfig(cap_slack=0.5, speculate=True):
        raise AssertionError("executor speculate relaxed_once: the ExecutorConfig changed")
    same_outputs(env_off, env_r, names, "speculation and the relaxed retry")
    relax.update(seen=[list(x) for x in seen], ft_counters=dict(ex_r.ft_counters))
    runs = {"warm": warm, "off": off, "on": on, "sorted": srt, "failing_clone": dies,
            "relaxed_once": relax}
    # how close a job that does not straggle came to being cloned
    margin = max(r["wall_over_deadline"]["max_other"] or 0.0 for r in runs.values())
    return {"part": "speculate", "rows_per_relation": rows, "straggle": STRAGGLE,
            "launches_per_job": per_job, "max_wall_over_deadline_not_straggling": margin,
            "runs": runs}


def poison_tenants():
    """The reference's ``_poison_workload`` (``tests/test_failure_domains.py``):
    three tenants' queries, tenant 1 guarding on its own ``PG``, named apart
    so that one plan holds all three."""
    from repro_torch.core.algebra import BSGF, Atom, all_of

    conds = [Atom(r, v) for r, v in zip("STUV", XYZW)]
    return [BSGF(f"Z{t}", XYZW, Atom("PG" if t == 1 else "R", *XYZW), all_of(*conds))
            for t in range(3)]


def poison(job, attempt):
    """``_poison_hook``: every job reading ``PG`` fails, blamed on ``PG``."""
    from repro_torch.core.executor import PermanentFault
    from repro_torch.core.planner import job_reads

    if "PG" in job_reads(job):
        raise PermanentFault("poison tenant", rels={"PG"})


def failure_sets(report) -> dict:
    return {"records": sorted((repr(r.job), r.outcome) for r in report.records),
            "failed": sorted(repr(r.job) for r in report.failed_jobs),
            "tainted_relations": sorted(report.tainted_relations())}


def executor_isolate(db, P, seed) -> dict:
    """(d) ``fail_policy="isolate"``: the three tenants in one 1-ROUND plan
    (one fused MSJ job), the job reading ``PG`` poisoned.  The failure sets
    depend on the plan alone: the same plan on the CPU at 2**8 rows is the
    oracle.  Untainted outputs equal the fault-free run's."""
    from repro_torch.core import queries
    from repro_torch.core.executor import Executor, ExecutorConfig
    from repro_torch.core.planner import plan_one_round
    from repro_torch.core.relation import db_from_dict
    from repro_torch.engine.comm import SimComm

    qs = poison_tenants()
    plan = plan_one_round(qs)
    (clean, rep_c), run_c = measured(lambda: Executor(dict(db), SimComm(P)).execute(plan))
    check_path_kernels("executor isolate clean", rep_c, run_c["launches"])
    ex = Executor(dict(db), SimComm(P), ExecutorConfig(fail_policy="isolate"))
    (env, rep), run = measured(lambda: ex.execute(plan, on_job=poison))
    check_path_kernels("executor isolate", rep, run["launches"])
    small = queries.gen_db(qs, n_guard=EXECUTOR_ORACLE_ROWS, n_cond=EXECUTOR_ORACLE_ROWS,
                           seed=seed)
    cpu_ex = Executor(db_from_dict(small, P=P, device="cpu"), SimComm(P),
                      ExecutorConfig(fail_policy="isolate"))
    _, cpu_rep = cpu_ex.execute(plan, on_job=poison)
    got, want = failure_sets(rep), failure_sets(cpu_rep)
    if got != want or not got["failed"] or "Z1" not in got["tainted_relations"]:
        raise AssertionError(f"executor isolate: failure sets {got}, the CPU plan's {want}")
    tainted = set(got["tainted_relations"])
    kept = [k for k in plan_outputs(plan) if k not in tainted]
    if "Z1" in env or not kept:
        raise AssertionError(f"executor isolate: published {sorted(env)}, kept {kept}")
    same_outputs(clean, env, kept, "the fault-free and isolated runs")
    return {"part": "isolate", "plan": "one_round of 3 tenants",
            "runs": {"clean": run_c, "isolate": run}, **got, "untainted": kept,
            "output_rows": {k: int(env[k].count()) for k in kept}}


def executor_shrink(db, P) -> dict:
    """(e) ``shrink_on_shard_loss``: A4's two pipelines planned PAR on two
    slots, shard 0 of the first job's first lineage relation lost once:
    recovered bit-identically from lineage, the rest run on one slot."""
    import torch

    from repro_torch.core import queries
    from repro_torch.core.executor import Executor, ExecutorConfig, ShardLoss
    from repro_torch.core.planner import job_reads, plan_par
    from repro_torch.engine.comm import SimComm
    from repro_torch.ft.elastic import lose_shard

    plan = plan_par(queries.make_queries("A4"))
    names = plan_outputs(plan)
    (clean, rep_c), run_c = measured(lambda: Executor(dict(db), SimComm(P)).execute(plan, slots=2))
    check_path_kernels("executor shrink clean", rep_c, run_c["launches"])
    ex = Executor(dict(db), SimComm(P), ExecutorConfig(shrink_on_shard_loss=True))
    lost = []

    def lose(job, attempt):
        if not lost:
            rel = sorted(job_reads(job) & ex.lineage.keys())[0]
            lost.append(rel)
            ex.env[rel] = lose_shard(ex.env[rel], 0)
            raise ShardLoss(rel, 0)

    (env, rep), run = measured(lambda: ex.execute(plan, slots=2, on_job=lose, max_restarts=2))
    check_path_kernels("executor shrink", rep, run["launches"])
    same_outputs(clean, env, names, "the fault-free run and the shrunk run")
    first_end = min(s.end for s in ex.schedule)
    later = [s for s in ex.schedule if s.start >= first_end]
    if ex.ft_counters["shard_recoveries"] != 1 or not later or {s.slot for s in later} != {0}:
        raise AssertionError(f"executor shrink: {ex.ft_counters}, later slots "
                             f"{[s.slot for s in later]}")
    src, got = ex.lineage[lost[0]], ex.env[lost[0]]
    if not (torch.equal(got.data, src.data) and torch.equal(got.valid, src.valid)):
        raise AssertionError(f"executor shrink: {lost[0]} differs from its lineage source")
    return {"part": "shrink", "plan": "A4 par",
            "runs": {"clean": run_c, "shrink": run}, "lost": [lost[0], 0],
            "ft_counters": dict(ex.ft_counters), "later_slots": sorted({s.slot for s in later}),
            "dispatches": [[s.idx, s.slot, s.start, s.end] for s in ex.schedule]}


def phase_executor(gdb, plan, P, greedy, seed, rows, host_work) -> dict:
    """The executor's fault-tolerant scheduling on the card, one line per
    part; returns the phase's launches for the ``kernels`` line.  Its
    database and ``host_work`` (futures of later phases' draws) run on host
    threads beside parts (a) and (b), and are waited for before part (c),
    so that no host thread runs beside the walls that decide speculation."""
    from repro_torch.core.relation import Relation

    t0 = time.perf_counter()
    host_db = in_background(executor_db, P, seed, rows)
    total = dict.fromkeys(counters(), 0)

    def part(fn, *args) -> None:
        t_part = time.perf_counter()
        line = fn(*args)
        for run in line["runs"].values():
            for k, v in run["launches"].items():
                total[k] += v
        emit({"phase": "executor", **line, "seconds": time.perf_counter() - t_part,
              "probe_launches": sum(r["launches"]["probe_bucketed"] for r in line["runs"].values()),
              "peak_mem_bytes": max(r["peak_mem_bytes"] for r in line["runs"].values())})

    part(executor_waves, gdb, plan, P, greedy)
    t_wait = time.perf_counter()
    db = {k: Relation(r.name, r.data.to(DEVICE), r.valid.to(DEVICE))
          for k, r in host_db.result().items()}
    emit({"phase": "executor", "part": "data", "rows_per_relation": rows, "relations": sorted(db),
          "seconds_after_waves": time.perf_counter() - t_wait})
    part(executor_edges, db, P)
    t_wait = time.perf_counter()
    for work in host_work:
        work.result()
    emit({"phase": "executor", "part": "host_work", "waited_s": time.perf_counter() - t_wait})
    part(executor_speculate, P, seed, rows)
    part(executor_isolate, db, P, seed)
    part(executor_shrink, db, P)
    result = {"phase": "executor", "part": "total", "seconds": time.perf_counter() - t0,
              "launches": total, "probe_wrapper": "probe_bucketed"}
    emit(result)
    return result


# --------------------------------------------------------------------------
# phase 5: oracle
# --------------------------------------------------------------------------


def phase_oracle() -> None:
    import numpy as np

    from repro_torch.core import ref_engine
    from repro_torch.core.algebra import And, Atom, BSGF, Or
    from repro_torch.core.costmodel import HADOOP, stats_of_db
    from repro_torch.core.executor import ExecutorConfig, execute_plan
    from repro_torch.core.planner import plan_greedy, plan_one_round, plan_par
    from repro_torch.core.relation import db_from_dict
    from repro_torch.engine.comm import SimComm

    P = 8
    rng = np.random.default_rng(0)
    db_np = {
        "R": rng.integers(0, 64, (2000, 2)).astype(np.int32),
        "S": rng.integers(0, 64, (1500, 2)).astype(np.int32),
        "T": rng.integers(0, 64, (1000, 2)).astype(np.int32),
    }
    query = BSGF("Z", ("x", "y"), Atom("R", "x", "y"),
                 And(Or(Atom("S", "x", "y"), Atom("S", "y", "x")), Atom("T", "x", "z")))
    want = ref_engine.eval_bsgf({k: {tuple(map(int, r)) for r in v} for k, v in db_np.items()},
                                query)
    db = db_from_dict(db_np, P=P)
    if any(r.data.device.type != DEVICE for r in db.values()):
        raise AssertionError("oracle: the default device is not the card")
    plans = {"par": plan_par([query]), "greedy": plan_greedy([query], stats_of_db(db), HADOOP),
             "one_round": plan_one_round([query]), "one_round_bloom": plan_one_round([query])}
    got = {}
    for name, plan in plans.items():
        cfg = ExecutorConfig(bloom_bits=4096 if name.endswith("bloom") else 0)
        env, report = execute_plan(db, plan, SimComm(P), cfg)
        z = env["Z"].to_set()
        if z != want:
            raise AssertionError(f"oracle: {name} plan disagrees with ref_engine")
        got[name] = {"rows": len(z), "jobs": report.n_jobs,
                     "backends": [r.backend for r in report.records if r.backend]}
    emit({"phase": "oracle", "want_rows": len(want), "plans": got, "set_equal": True})


# --------------------------------------------------------------------------
# phase: the examples
# --------------------------------------------------------------------------

#: the backend the cost model picks for each MSJ job of each example on
#: card-resident data, per executed plan in order (its per-job prices: the
#: PAR plan's job on the 9-row ``Blocked`` has about one build row a shard,
#: where the all-pairs compare is cheapest)
EXAMPLE_BACKENDS = {
    "quickstart": [["kernel"] * 3, ["kernel"], ["kernel"]],
    "data_pipeline": [["kernel", "kernel", "dense", "kernel"], ["kernel"], ["kernel"]],
    "sgf_service": [["kernel"], ["kernel"]],
    "serve_lm": [],
    "train_lm": [["kernel"]],
}
#: what the reference scripts print that does not depend on the hardware
QUICKSTART_PLANS = {"PAR": (830, 4, 2, 246008), "GREEDY": (830, 2, 2, 223748),
                    "1-ROUND": (830, 1, 1, 139748)}  # rows, jobs, rounds, bytes
DATA_PIPELINE = {"par": (6672, 5, 2038284), "greedy": (6672, 2, 1945140),
                 "one_round": (6672, 1, 1003884)}  # kept, jobs, bytes


class executor_reports:
    """Every report ``Executor.execute`` returns inside the block, in order."""

    def __enter__(self) -> list:
        from repro_torch.core.executor import Executor

        self.execute, reports = Executor.execute, []

        def execute(ex, *args, **kwargs):
            env, report = self.execute(ex, *args, **kwargs)
            reports.append(report)
            return env, report

        Executor.execute = execute
        return reports

    def __exit__(self, *exc) -> None:
        from repro_torch.core.executor import Executor

        Executor.execute = self.execute


def example_checks(name, out) -> dict:
    """The hardware-independent numbers of an example against the
    reference script's; raises on a difference."""
    import json

    if name == "quickstart":
        got = {k: (v["rows"], v["jobs"], v["rounds"], v["bytes_shuffled"])
               for k, v in out["plans"].items()}
        if out["oracle_rows"] != 830 or got != QUICKSTART_PLANS:
            raise AssertionError(f"quickstart: {out['oracle_rows']} {got}")
    elif name == "data_pipeline":
        got = {k: (v["kept"], v["jobs"], v["bytes_shuffled"])
               for k, v in out["strategies"].items()}
        if (out["docs"], out["dup_hashes"], out["blocked_domains"]) != (16384, 7698, 9) \
                or got != DATA_PIPELINE:
            raise AssertionError(f"data_pipeline: {got}")
    elif name == "sgf_service":
        cold, warm = out["ticks"][:2]
        if (cold["canonical"], cold["deduped"], cold["jobs"], cold["bytes_shuffled"],
                warm["jobs"], warm["bytes_shuffled"]) != (4, 4, 2, 1018184, 0, 0):
            raise AssertionError(f"sgf_service: ticks {cold} {warm}")
        with open(out["trace"]) as f:
            trace = json.load(f)
        return {"trace_events": len(trace["traceEvents"])}
    elif name == "train_lm":
        if (out["kept"], out["jobs"], out["bytes_shuffled"]) != (1934, 1, 248948):
            raise AssertionError(f"train_lm: stage 1 {out}")
    return {}


def serve_lm_on_host(tokens) -> dict:
    """``examples/serve_lm.py``'s requests served on the CPU with the card's
    weights (seed 0 drawn on the card, copied), float32: the tokens must
    equal the card's."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm
    from repro_torch.models import model

    cfg = get_config("qwen3-0.6b", smoke=True, dtype="float32")
    params = model.params_from_numpy(
        cfg, model.params_to_numpy(model.init_params(cfg, 0, device=DEVICE)), device="cpu")
    reqs = serve_lm.make_requests(cfg, 6, 8)
    t0 = time.perf_counter()
    serve_lm.serve(cfg, params, reqs)
    host = [r.out for r in reqs]
    if host != tokens:
        raise AssertionError(f"serve_lm: card tokens {tokens}, host tokens {host}")
    return {"host_s": time.perf_counter() - t0, "tokens_equal_host": True}


def train_lm_first_step() -> dict:
    """One step of ``examples/train_lm.py``'s stage 2 on the card and on the
    CPU from the same state (seed 0 drawn on the card, copied) and batch:
    the losses within ``RESTART_LOSS_TOL`` relative."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.examples import train_lm
    from repro_torch.models import model
    from repro_torch.train import optimizer, train_step as ts

    cfg = get_config("qwen3-0.6b", smoke=True)
    opt_cfg = optimizer.OptConfig(lr=1e-3, warmup_steps=20, total_steps=200)
    kept, _ = train_lm.curate(4096, seed=1, P=8, device="cpu")
    card = ts.init_state(cfg, 0, opt_cfg, device=DEVICE)
    cpu = ts.init_state(cfg, 0, opt_cfg, device="cpu")
    with torch.no_grad():
        for p, q in zip(cpu["params"].parameters(), card["params"].parameters(), strict=True):
            p.copy_(q.cpu())
    loss, secs = {}, {}
    for where, state in (("card", card), ("cpu", cpu)):
        device = DEVICE if where == "card" else "cpu"
        t0 = time.perf_counter()
        _, hist, _ = train_lm.train(cfg, opt_cfg, state,
                                    train_lm.kept_batch_fn(cfg, kept, 8, 128, device),
                                    steps=1, log_every=1)
        loss[where], secs[where] = hist[0][1], time.perf_counter() - t0
    err = abs(loss["card"] - loss["cpu"]) / loss["cpu"]
    if not err <= RESTART_LOSS_TOL:
        raise AssertionError(f"train_lm: first-step loss card {loss['card']} against cpu "
                             f"{loss['cpu']}: {err} > {RESTART_LOSS_TOL}")
    return {"first_loss_card": loss["card"], "first_loss_cpu": loss["cpu"],
            "first_loss_rel_err": err, "first_step_s": secs}


def phase_examples() -> list:
    """``repro_torch.examples``: each module's ``main`` in this process on
    the card, in a temporary working directory, at the reference script's
    defaults (``train_lm``: 200 steps of the SMOKE qwen3-0.6b at 8 x 128),
    every launch counter set to 0 just before and read just after; each
    MSJ job on the backend of ``EXAMPLE_BACKENDS``, the hardware-independent
    numbers the reference scripts print, ``serve_lm``'s tokens against the
    CPU's and ``train_lm``'s first-step loss against one step on the CPU.
    One line each; returns them (their launches count on the kernels line)."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.examples import data_pipeline, quickstart, serve_lm, sgf_service, train_lm

    mains = {"quickstart": quickstart.main, "data_pipeline": data_pipeline.main,
             "sgf_service": sgf_service.main, "serve_lm": serve_lm.main,
             "train_lm": train_lm.main}
    lines = []
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        for name, main in mains.items():
            printed = io.StringIO()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with executor_reports() as reports, contextlib.redirect_stdout(printed):
                out = main([])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            if out["device"] != str(torch.device(DEVICE)):
                raise AssertionError(f"{name}: ran on {out['device']}")
            want = EXAMPLE_BACKENDS[name]
            if len(reports) != len(want):
                raise AssertionError(f"{name}: {len(reports)} executed plans, not {len(want)}")
            backends = [check_path_kernels(f"{name} plan {i}", rep, launches, backend=w)
                        for i, (rep, w) in enumerate(zip(reports, want))]
            if not want and any(launches.values()):
                raise AssertionError(f"{name}: kernels launched off the MSJ path: {launches}")
            extra = example_checks(name, out)
            with contextlib.redirect_stdout(io.StringIO()):  # the comparisons' own prints
                if name == "serve_lm":
                    extra.update(serve_lm_on_host(out["tokens"]))
                elif name == "train_lm":
                    extra.update(train_lm_first_step())
            line = {"phase": "examples", "example": name, "wall_s": wall, "numbers": out,
                    "msj_backends": backends, "launches": launches,
                    "probe_wrapper": "probe_bucketed", **extra,
                    "printed": printed.getvalue().splitlines()}
            emit(line)
            lines.append(line)
    return lines


# --------------------------------------------------------------------------
# phase 7: the SGF query service
# --------------------------------------------------------------------------

def sorted_rows(rel):
    """The valid rows of a relation in lexicographic order, on the card."""
    import torch

    rows = rel.data.reshape(-1, rel.arity)[rel.valid.reshape(-1)]
    for c in reversed(range(rows.shape[1])):
        rows = rows[torch.argsort(rows[:, c], stable=True)]
    return rows


def same_set(a, b) -> bool:
    import torch

    return torch.equal(sorted_rows(a), sorted_rows(b))


def same_arrays(a, b) -> bool:
    import torch

    return torch.equal(a.data, b.data) and torch.equal(a.valid, b.valid)


def outputs_of(reqs) -> list:
    return [r.outputs["Z0"] for r in reqs]


def tick(svc, tenants, label, *, want=None, bit_identical=None, bloom=False, warm=False,
         extra=None):
    """Submit every tenant's query, run one ``tick()`` on the card with the
    launch counters set to 0 just before it, check it and print its line.
    ``want``: outputs the tick must equal as sets; ``bit_identical``:
    outputs it must equal in ``data`` and ``valid``; ``warm``: the tick
    must run 0 jobs, shuffle 0 bytes and launch nothing, else every MSJ job
    must run the probe kernel (and, with ``bloom``, the bloom kernels)."""
    import torch

    from repro_torch.core.planner import MSJJob

    reqs = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    done = svc.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if done != reqs:
        raise AssertionError(f"service {label}: {len(done)} of {len(reqs)} requests completed")
    rep = svc.last_report
    msj = [r for r in rep.records if isinstance(r.job, MSJJob)]
    if warm:
        if rep.n_jobs or rep.bytes_shuffled() or any(launches.values()):
            raise AssertionError(f"service {label}: a warm tick ran {rep.n_jobs} jobs, "
                                 f"{rep.bytes_shuffled()} bytes, launches {launches}")
    else:
        check_path_kernels(f"service {label}", rep, launches, bloom)
    outs = outputs_of(reqs)
    if want is not None and not all(same_set(a, b) for a, b in zip(outs, want)):
        raise AssertionError(f"service {label}: outputs differ from the expected sets")
    if bit_identical is not None and not all(
            same_arrays(a, b) for a, b in zip(outs, bit_identical)):
        raise AssertionError(f"service {label}: outputs are not bit-identical")
    c = svc.counters()
    line = {
        "phase": "service", "tick": label, "wall_s": wall, "jobs": rep.n_jobs,
        "msj_jobs": len(msj), "bytes_shuffled": rep.bytes_shuffled(),
        "peak_mem_bytes": peak, "launches": launches,
        "warm_queries": svc.last_tick.get("warm_queries", 0),
        "cold_queries": svc.last_tick.get("cold_queries", 0),
        "x_injected": svc.last_tick.get("x_injected", 0),
        "plan_cache": {k: c[k] for k in ("hits", "misses", "collisions", "size")},
        "result_cache": {k: c[k] for k in ("query_hits", "query_misses", "x_hits", "x_misses",
                                           "stale_evicted", "partial_skipped", "result_size")},
        "output_rows": [int(o.count()) for o in outs],
        **(extra or {}),
    }
    emit(line)
    return reqs, line


def run_baseline(catalog, tenants, P):
    """The tenants one after another, each through its own ``Executor`` and
    ``plan_greedy`` (after one warm-up pass): ``(outputs, line)``."""
    import torch

    from repro_torch.core.costmodel import HADOOP
    from repro_torch.core.executor import Executor, ExecutorConfig
    from repro_torch.core.planner import MSJJob, plan_greedy
    from repro_torch.engine.comm import SimComm

    def run_all():
        outs, jobs, msj, nbytes = [], 0, 0, 0
        for qs in tenants:
            stats = catalog.stats()
            plan = plan_greedy(qs, stats, HADOOP)
            ex = Executor(catalog.db(), SimComm(P), ExecutorConfig(), stats=stats)
            env, rep = ex.execute(plan)
            outs.append(env["Z0"])
            jobs += rep.n_jobs
            msj += sum(isinstance(r.job, MSJJob) for r in rep.records)
            nbytes += rep.bytes_shuffled()
        return outs, jobs, msj, nbytes

    run_all()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs, jobs, msj, nbytes = run_all()
    torch.cuda.synchronize()
    line = {"phase": "service", "tick": "baseline", "wall_s": time.perf_counter() - t0,
            "jobs": jobs, "msj_jobs": msj, "bytes_shuffled": nbytes,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": read_counts(),
            "output_rows": [int(o.count()) for o in outs]}
    emit(line)
    return outs, line


def service_oracle(P) -> None:
    """One tick at 2**12 rows on the card, set-equal to the indexed oracle
    (``ref_engine.indexed_bsgf``, held to ``ref_engine.eval_bsgf`` by
    ``tests/test_torch_service.py``); its line gives the seconds of the
    tick and of the oracle apart."""
    import torch

    from repro_torch.core import queries
    from repro_torch.core.ref_engine import indexed_bsgf
    from repro_torch.service import SGFService, catalog_from_numpy

    t_start = time.perf_counter()
    tenants = [queries.tenant_queries(t) for t in range(4)]
    db_np = queries.gen_db([q for qs in tenants for q in qs], n_guard=2**12, n_cond=2**12,
                           sel=0.5, seed=7)
    svc = SGFService(catalog_from_numpy(db_np, P=P))
    if svc.catalog.get("R").data.device.type != DEVICE:
        raise AssertionError("service oracle: the catalog is not on the card")
    reqs = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.tick()
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    got = [req.outputs["Z0"].to_set() for req in reqs]
    t0 = time.perf_counter()
    setdb = {k: {tuple(map(int, r)) for r in v} for k, v in db_np.items()}
    want = [indexed_bsgf(setdb, qs[0]) for qs in tenants]
    oracle_s = time.perf_counter() - t0
    for req, g, w in zip(reqs, got, want):
        if g != w:
            raise AssertionError(f"service oracle: tenant {req.tenant} disagrees with the "
                                 "indexed oracle")
    emit({"phase": "service", "tick": "oracle", "rows_per_relation": 2**12, "P": P,
          "output_rows": [len(g) for g in got], "set_equal": True, "tick_s": tick_s,
          "oracle": "indexed_bsgf", "oracle_s": oracle_s,
          "seconds": time.perf_counter() - t_start})


def phase_service(log2_rows, P, seed) -> list:
    """The service path on the card: a catalog of ``2**log2_rows`` rows per
    relation on ``P`` shards, the four tenants of the reference's service
    bench, and the ticks of the module docstring.  Returns every line that
    counted kernel launches."""
    import numpy as np
    import torch

    from repro_torch.core import queries
    from repro_torch.core.executor import ExecutorConfig, ShardLoss
    from repro_torch.core.planner import MSJJob, job_reads
    from repro_torch.ft.elastic import lose_shard
    from repro_torch.ft.supervisor import SimulatedFault
    from repro_torch.obs import (
        MetricRegistry,
        Tracer,
        audit_trace,
        report_from_trace,
        validate_trace,
        write_trace,
    )
    from repro_torch.service import SGFService, catalog_from_numpy

    rows = 2**log2_rows
    tenants = [queries.tenant_queries(t) for t in range(4)]
    t_phase = t0 = time.perf_counter()
    db_np = queries.gen_db([q for qs in tenants for q in qs], n_guard=rows, n_cond=rows,
                           sel=0.5, seed=seed)
    catalog = catalog_from_numpy(db_np, P=P)
    torch.cuda.synchronize()
    emit({"phase": "service", "tick": "catalog", "rows_per_relation": rows, "P": P,
          "relations": {n: list(catalog.get(n).data.shape) for n in catalog.names()},
          "device": str(catalog.device), "seconds": time.perf_counter() - t0,
          "resident_bytes": sum(catalog.get(n).data.nbytes + catalog.get(n).valid.nbytes
                                for n in catalog.names())})
    if catalog.get("R").data.device.type != DEVICE:
        raise AssertionError("service: the catalog is not on the card")
    lines = []

    base_out, line = run_baseline(catalog, tenants, P)
    lines.append(line)

    svc = SGFService(catalog)
    cold, line = tick(svc, tenants, "cold", want=base_out)
    cold_out = outputs_of(cold)
    cold_stats = [r.stats for r in svc.last_report.records]
    lines.append(line)
    # the probe kernels at the fused tick's shapes, held against the torch
    # sort-merge probe: the same tick on a fresh service, bit-identical
    # outputs and equal per-job counters (the baseline runs the kernel too)
    plain = SGFService(catalog, config=ExecutorConfig(probe_backend="sorted"))
    reqs = [plain.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    backends = [r.backend for r in plain.last_report.records if isinstance(r.job, MSJJob)]
    if not backends or any(b != "sorted" for b in backends):
        raise AssertionError(f"service cold_sorted: MSJ jobs ran {backends}, not sorted")
    if not all(same_arrays(a, b) for a, b in zip(outputs_of(reqs), cold_out)):
        raise AssertionError("service: the kernel and sort-merge cold ticks differ")
    if [r.stats for r in plain.last_report.records] != cold_stats:
        raise AssertionError("service: the kernel and sort-merge cold ticks' counters differ")
    emit({"phase": "service", "tick": "cold_sorted", "wall_s": wall, "msj_backends": backends,
          "bit_identical": True, "stats_equal": True})
    del plain, reqs
    # the cold tick's phases: the same tick once more on a fresh service,
    # with a tracer that synchronizes after each stage
    traced = SGFService(catalog, tracer=Tracer(trace_sync=True))
    reqs = [traced.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traced.tick()
    torch.cuda.synchronize()
    emit({"phase": "service", "tick": "cold_traced", "traced_wall_s": time.perf_counter() - t0,
          "phase_s": phase_seconds(traced.last_report)})
    if not all(same_arrays(a, b) for a, b in zip(outputs_of(reqs), cold_out)):
        raise AssertionError("service: the traced cold tick is not bit-identical")
    del traced, reqs

    _, line = tick(svc, tenants, "warm", bit_identical=cold_out, warm=True)
    lines.append(line)
    catalog.register("BYSTANDER", np.arange(64, dtype=np.int32).reshape(16, 4))
    _, line = tick(svc, tenants, "unrelated_register", bit_identical=cold_out, warm=True)
    lines.append(line)
    catalog.register("S", db_np["S"])
    _, line = tick(svc, tenants, "dependent_register", want=cold_out)
    if line["warm_queries"] != 0 or line["cold_queries"] != len(tenants) or not line["x_injected"]:
        raise AssertionError(f"service dependent_register: {line['warm_queries']} warm, "
                             f"{line['cold_queries']} cold queries, {line['x_injected']} "
                             "warm semi-join materializations")
    lines.append(line)
    del svc

    # sanitized, traced and metered; its report exported to Perfetto
    seen = []
    metrics = MetricRegistry()
    svc = SGFService(catalog, config=ExecutorConfig(sanitize=True), tracer=Tracer(),
                     metrics=metrics)

    def keep_executor(job, attempt):  # the tick's Executor holds last_sanitize
        if not seen:
            seen.append(svc._executor)

    svc.on_job = keep_executor
    _, line = tick(svc, tenants, "sanitized", bit_identical=cold_out)
    if seen[0].last_sanitize != []:
        raise AssertionError(f"service sanitized: findings {seen[0].last_sanitize}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = write_trace(str(out_dir / "service_tick.trace.json"), svc.last_report,
                       metrics=metrics, title="service cold tick")
    doc = json.loads(Path(path).read_text())
    problems, findings = validate_trace(doc), audit_trace(doc)
    rep, rep2 = svc.last_report, report_from_trace(doc)
    replay = (rep2.total_time == rep.total_time and rep2.net_time == rep.net_time
              and all(rep2.net_time_by_events(w) == rep.net_time_by_events(w)
                      for w in (None, 1, 2)))
    if problems or findings or not replay:
        raise AssertionError(f"service trace: schema {problems}, audit {findings}, "
                             f"replay bit-exact {replay}")
    emit({"phase": "service", "tick": "sanitized_trace", "last_sanitize": [],
          "trace": str(Path(path).relative_to(ROOT)), "trace_events": len(doc["traceEvents"]),
          "validate_trace": problems, "audit_findings": len(findings), "replay_bit_exact": replay,
          "metrics": {k: v for k, v in metrics.snapshot().items() if not isinstance(v, dict)}})
    lines.append(line)
    del svc

    # chaos: shard 3 of R lost on the first attempt of the first job that
    # reads R, one injected fault on the first attempt of the next job
    r_before = (catalog.get("R").data.clone(), catalog.get("R").valid.clone())
    seen, events = [], []
    svc = SGFService(catalog)
    svc.max_restarts = 2

    def chaos(job, attempt):
        ex = svc._executor
        if not seen:
            seen.append(ex)
        if attempt == 1 and "R" in job_reads(job) and "shard_loss" not in events:
            events.append("shard_loss")
            ex.env["R"] = lose_shard(ex.env["R"], 3)
            raise ShardLoss("R", 3)
        if attempt == 1 and events == ["shard_loss"]:
            events.append("simulated_fault")
            raise SimulatedFault(f"injected fault on {job}")

    svc.on_job = chaos
    _, line = tick(svc, tenants, "chaos", bit_identical=cold_out)
    ft = dict(seen[0].ft_counters)
    r_intact = (torch.equal(catalog.get("R").data, r_before[0])
                and torch.equal(catalog.get("R").valid, r_before[1]))
    r_restored = same_arrays(seen[0].env["R"], catalog.get("R"))
    if (events != ["shard_loss", "simulated_fault"] or ft["shard_recoveries"] != 1
            or ft["fault_retries"] != 2 or not r_intact or not r_restored):
        raise AssertionError(f"service chaos: events {events}, ft_counters {ft}, catalog R "
                             f"intact {r_intact}, live R restored {r_restored}")
    emit({"phase": "service", "tick": "chaos_ft", "events": events, "ft_counters": ft,
          "catalog_R_intact": r_intact, "live_R_restored": r_restored})
    lines.append(line)
    del svc, seen, r_before

    svc = SGFService(catalog, config=ExecutorConfig(bloom_bits=rows))
    cold_bytes = lines[1]["bytes_shuffled"]
    _, line = tick(svc, tenants, "bloom", want=cold_out, bloom=True,
                   extra={"bloom_bits": rows, "bytes_shuffled_cold": cold_bytes})
    lines.append(line)
    del svc, catalog, cold_out, base_out
    torch.cuda.empty_cache()

    service_oracle(P)
    emit({"phase": "service", "tick": "done", "seconds": time.perf_counter() - t_phase})
    return lines


# --------------------------------------------------------------------------
# phase 9: serving the model zoo (dense, MoE, SSM, hybrid)
# --------------------------------------------------------------------------

#: the ``lm_serve`` phase's sizes, one spec per family, each at its
#: published config (``check_layers``: the card-against-CPU step's depth
#: cut, which keeps the CPU's copy small; None runs the whole model there)
_SERVE_STEPS = {"check_prompt": 64, "check_decode": 2, "check_max_len": 128,
                "tf_len": 1021,  # a prime: the reference's chunking falls to chunks of 1
                "batch_requests": 8, "batch_prompt": (17, 300), "batch_max_new": 16,
                "batch_max_batch": 4, "batch_max_len": 512,
                "serve_prompt": (128, 2048), "serve_max_len": 4096}
LM_SERVE = [
    {**_SERVE_STEPS, "arch": "qwen3-0.6b", "smoke": False, "check_layers": None,
     "serve_requests": 32, "serve_max_new": 128, "serve_max_batch": 16, "sdpa_len": 2048},
    {**_SERVE_STEPS, "arch": "olmoe-1b-7b", "smoke": False, "check_layers": 2,
     "serve_requests": 32, "serve_max_new": 64, "serve_max_batch": 16,
     "moe_dispatch_tokens": 2048},
    {**_SERVE_STEPS, "arch": "falcon-mamba-7b", "smoke": False, "check_layers": 2,
     "serve_requests": 32, "serve_max_new": 64, "serve_max_batch": 16, "scan_len": 256},
    {**_SERVE_STEPS, "arch": "zamba2-7b", "smoke": False,
     "check_layers": 7,  # one group of 6 and one tail layer
     "serve_requests": 16, "serve_max_new": 64, "serve_max_batch": 8},
    # the stub-frontend families serve through greedy_generate (the
    # reference's Batcher and serve launcher take tokens only): 576 patch
    # embeddings (phi-3-vision's published frontend) or 512 frames per request
    {**_SERVE_STEPS, "arch": "phi-3-vision-4.2b", "smoke": False, "check_layers": 2,
     "batch_requests": 4, "batch_prompt": 97, "serve_batch": 8, "serve_text": (512, 1472),
     "serve_max_new": 64},
    {**_SERVE_STEPS, "arch": "seamless-m4t-medium", "smoke": False, "check_layers": None,
     "frames": 512, "batch_requests": 4, "batch_prompt": 97, "serve_batch": 8,
     "serve_text": (256, 1024), "serve_max_new": 64},
]
CARD_VS_CPU_TOL = 1e-3  # max |Δlogit| / max |logit|, float32 without TF32
TEACHER_FORCING_TOL = 2e-3  # the reference's own bound (tests/test_models.py)
MOE_DISPATCH_TOL = 1e-4  # moe_sort with nothing dropped against moe_dense, float32
SCAN_TOL = 1e-3  # chunked mamba1 against its recurrence (tests/test_models.py: rtol 1e-3)
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 (data sheet)
KV_LEAVES = ("k", "v", "attn_k", "attn_v")  # (layers, B, T, Hkv, D)
STATE_LEAVES = ("conv", "ssm", "conv_tail", "ssm_tail")  # per-slot SSM state


def is_prime(n: int) -> bool:
    return n > 1 and all(n % d for d in range(2, math.isqrt(n) + 1))


def prompt_lengths(rng, n, lo, hi) -> list:
    """``n`` lengths drawn from [lo, hi], at least one of them prime."""
    lens = [int(x) for x in rng.integers(lo, hi + 1, n)]
    if not any(map(is_prime, lens)):
        primes = [p for p in range(lo, hi + 1) if is_prime(p)]
        lens[0] = primes[int(rng.integers(len(primes)))]
    return lens


def rel_err(want, got) -> float:
    return float((want - got).abs().max() / want.abs().max())


def lm_card_vs_cpu(cfg, params, rng, spec, seed) -> dict:
    """Prefill + decode logits on the card against the CPU, same weights
    (carried across with ``params_to_numpy`` / ``params_from_numpy``).
    With ``check_layers`` the step builds its own model of that depth at
    full width from ``seed``, so that no whole 7B model is copied to the
    host."""
    import dataclasses

    import torch

    from repro_torch.models import model

    t0 = time.perf_counter()
    reduced = None
    if spec["check_layers"]:
        reduced = {"n_layers": [spec["check_layers"], cfg.n_layers]}
        cfg = dataclasses.replace(cfg, n_layers=spec["check_layers"])
        params = model.init_params(cfg, seed, device=DEVICE)
    S, n_dec = spec["check_prompt"], spec["check_decode"]
    toks = rng.integers(0, cfg.vocab, (1, S + n_dec))
    emb = frontend_embeds(cfg, spec, 1, rng, "cpu")
    max_len = spec["check_max_len"] + n_prefix(cfg, emb)
    cpu = model.params_from_numpy(cfg, model.params_to_numpy(params), device="cpu")
    outs = {}
    for where, p in (("card", params), ("cpu", cpu)):
        with torch.inference_mode():
            t = torch.as_tensor(toks, device=p.device)
            batch = with_embeds({"tokens": t[:, :S]}, emb, p.device)
            cache, logits = model.prefill(cfg, p, batch, max_len)
            seq = [logits]
            for i in range(n_dec):
                cache, logits = model.decode_step(cfg, p, cache, t[:, S + i:S + i + 1])
                seq.append(logits)
        outs[where] = torch.stack(seq).cpu()
    del params, cpu
    err = rel_err(outs["cpu"], outs["card"])
    line = {"phase": "lm_serve", "arch": cfg.name, "step": "card_vs_cpu", "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "reduced": reduced, "prompt": S, "decode_steps": n_dec,
            "frontend_positions": None if emb is None else emb.shape[1],
            "rel_err": err, "tol": CARD_VS_CPU_TOL,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if not err <= CARD_VS_CPU_TOL:
        raise AssertionError(f"lm_serve {cfg.name}: card and CPU logits differ by {err} "
                             "relative")
    return line


def frontend_embeds(cfg, spec, B, rng, device):
    """The stub frontend's embeddings for ``B`` requests, float32 draws
    from ``rng`` (normal, std 0.1, as the reference's synthetic batches):
    ``frontend_tokens`` patches for a VLM, ``spec["frames"]`` frames for
    the enc-dec; None for a token-only family."""
    import torch

    if cfg.family == "vlm":
        n = cfg.frontend_tokens
    elif cfg.family == "audio":
        n = spec["frames"]
    else:
        return None
    x = rng.normal(0, 0.1, (B, n, cfg.d_model)).astype("float32")
    return torch.as_tensor(x, device=device)


def n_prefix(cfg, emb) -> int:
    """Positions the frontend adds in front of the decoder's KV cache."""
    return emb.shape[1] if cfg.family == "vlm" else 0


def with_embeds(batch, emb, device):
    return batch if emb is None else {**batch, "embeds": emb.to(device)}


def last_hidden(cfg, params, tokens, emb=None):
    """The family's full-sequence forward, final hidden state of the last
    position."""
    from repro_torch.models import encdec, hybrid, ssm_model, transformer

    batch = {"tokens": tokens}
    if cfg.family == "ssm":
        return ssm_model.forward(cfg, params, batch)[:, -1]
    if cfg.family == "hybrid":
        return hybrid.forward(cfg, params, batch)[:, -1]
    if cfg.family == "audio":
        return encdec.decode_full(cfg, params, tokens, encdec.encode(cfg, params, emb))[0][:, -1]
    return transformer.forward(cfg, params, with_embeds(batch, emb, tokens.device))[0][:, -1]


def lm_teacher_forcing(cfg, params, rng, spec) -> dict:
    """prefill(S-1) + decode(1) against forward(S)'s last position."""
    import torch

    from repro_torch.models import model

    t0 = time.perf_counter()
    S = spec["tf_len"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)), device=params.device)
    emb = frontend_embeds(cfg, spec, 1, rng, params.device)
    with torch.inference_mode():
        cache, _ = model.prefill(cfg, params, with_embeds({"tokens": toks[:, :-1]}, emb,
                                                          params.device),
                                 S + n_prefix(cfg, emb))
        _, dec = model.decode_step(cfg, params, cache, toks[:, -1:])
        del cache
        ref = last_hidden(cfg, params, toks, emb) @ params.lm_head
    err = rel_err(ref, dec)
    line = {"phase": "lm_serve", "arch": cfg.name, "step": "teacher_forcing",
            "dtype": cfg.dtype, "n_layers": cfg.n_layers, "S": S, "S_is_prime": is_prime(S),
            "frontend_positions": None if emb is None else emb.shape[1],
            "rel_err": err, "tol": TEACHER_FORCING_TOL, "seconds": time.perf_counter() - t0}
    emit(line)
    if not err <= TEACHER_FORCING_TOL:
        raise AssertionError(f"lm_serve {cfg.name}: decode and teacher forcing differ by "
                             f"{err} relative")
    return line


def lm_batching(cfg, params, rng, spec) -> dict:
    """The continuous batcher's tokens against unbatched greedy generation."""
    import numpy as np
    import torch

    from repro_torch.serve.batcher import Batcher, Request
    from repro_torch.serve.serve_step import greedy_generate

    t0 = time.perf_counter()
    lens = prompt_lengths(rng, spec["batch_requests"], *spec["batch_prompt"])
    max_new, max_len = spec["batch_max_new"], spec["batch_max_len"]
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), max_new)
            for i, n in enumerate(lens)]
    b = Batcher(cfg, params, max_batch=spec["batch_max_batch"], max_len=max_len)
    for r in reqs:
        b.submit(r)
    b.run()
    for r in reqs:
        batch = {"tokens": torch.as_tensor(r.prompt[None, :], device=params.device)}
        want = greedy_generate(cfg, params, batch, steps=max_new, max_len=max_len)[0].tolist()
        if not r.done or want != r.out:
            raise AssertionError(f"lm_serve {cfg.name}: request {r.rid} (prompt "
                                 f"{len(r.prompt)}) batched {r.out}, unbatched {want}")
    line = {"phase": "lm_serve", "arch": cfg.name, "step": "batching", "dtype": cfg.dtype,
            "prompts": lens, "max_new": max_new, "max_batch": spec["batch_max_batch"],
            "max_len": max_len, "tokens_equal": True, "seconds": time.perf_counter() - t0}
    emit(line)
    return line


def lm_moe_dispatch(cfg, params, rng, spec) -> dict:
    """One layer's experts at full width over ``moe_dispatch_tokens``
    tokens: ``moe_sort`` with capacity factor E/k (C = N, nothing drops)
    against ``moe_dense``; at the config's capacity factor, the dropped
    (token, expert) pairs counted by the dispatch against a plain recount
    on the host from the same router indices.  Times both paths."""
    import numpy as np
    import torch

    from repro_torch.models import moe

    t0 = time.perf_counter()
    layer = params.layers[0].moe
    N, E, k = spec["moe_dispatch_tokens"], cfg.n_experts, cfg.top_k
    x = torch.as_tensor(rng.standard_normal((1, N, cfg.d_model)), dtype=torch.float32,
                        device=params.device)
    with torch.inference_mode():
        dense = moe.moe_dense(layer, x, k)
        ample = moe.moe_sort(layer, x, k, E / k)
        err = rel_err(dense, ample)
        C = moe.capacity(N, k, E, cfg.capacity_factor)
        idx, _ = moe.router_topk(x.reshape(N, -1), layer.router, k)
        dropped = int((~moe.dispatch(idx, E, C)[2]).sum())
        counts = np.bincount(idx.cpu().numpy().ravel(), minlength=E)
        recount = int(np.maximum(counts - C, 0).sum())
        capped = moe.moe_sort(layer, x, k, cfg.capacity_factor)
        finite = bool(torch.isfinite(capped).all())
        dense_ms = cuda_ms(lambda: moe.moe_dense(layer, x, k), 5)
        sort_ms = cuda_ms(lambda: moe.moe_sort(layer, x, k, cfg.capacity_factor), 5)
    line = {"phase": "lm_serve", "arch": cfg.name, "step": "moe_dispatch", "dtype": cfg.dtype,
            "tokens": N, "experts": E, "top_k": k, "rel_err_no_drops": err,
            "tol": MOE_DISPATCH_TOL, "capacity_factor": cfg.capacity_factor, "capacity": C,
            "dropped_pairs": dropped, "dropped_recount": recount, "pairs": N * k,
            "expert_load_max": int(counts.max()), "finite": finite, "dense_ms": dense_ms,
            "sort_ms": sort_ms, "seconds": time.perf_counter() - t0}
    emit(line)
    if not (err <= MOE_DISPATCH_TOL and dropped == recount and finite):
        raise AssertionError(f"lm_serve {cfg.name}: moe_dispatch failed: {line}")
    return line


def lm_scan(cfg, params, rng, spec) -> dict:
    """One Mamba-1 layer at full width: the chunked block against its
    token-by-token decode recurrence over ``scan_len`` tokens (the
    reference's own check, ``tests/test_models.py``)."""
    import torch

    from repro_torch.models import ssm

    t0 = time.perf_counter()
    S, N = spec["scan_len"], cfg.ssm_state
    layer = params.layers[0].mamba
    x = torch.as_tensor(rng.standard_normal((1, S, cfg.d_model)), dtype=torch.float32,
                        device=params.device)
    with torch.inference_mode():
        full = ssm.mamba1(layer, x, d_state=N, chunk=cfg.ssm_chunk)
        cache = ssm.mamba1_init_cache(layer, 1, N, dtype=torch.float32)
        steps = []
        for i in range(S):
            cache, y = ssm.mamba1_decode(layer, cache, x[:, i], d_state=N)
            steps.append(y)
        err = rel_err(full, torch.stack(steps, 1))
    line = {"phase": "lm_serve", "arch": cfg.name, "step": "scan", "dtype": cfg.dtype, "S": S,
            "chunk": cfg.ssm_chunk, "d_inner": layer.conv_w.shape[0], "rel_err": err,
            "tol": SCAN_TOL, "seconds": time.perf_counter() - t0}
    emit(line)
    if not err <= SCAN_TOL:
        raise AssertionError(f"lm_serve {cfg.name}: chunked scan and recurrence differ by "
                             f"{err} relative")
    return line


def lm_first_tokens(cfg, params, prompts) -> list:
    """Each prompt's first generated token (the prefill's argmax)."""
    import torch

    from repro_torch.serve.serve_step import make_prefill

    out = []
    for prompt in prompts:
        batch = {"tokens": torch.as_tensor(prompt[None, :], device=params.device)}
        out.append(int(torch.argmax(make_prefill(cfg, len(prompt))(params, batch)[1][0])))
    return out


def cache_bytes(cache) -> tuple:
    """(bytes of one position of every KV leaf, KV positions per slot T,
    bytes of one slot's SSM state) of a batch cache."""
    B = cache["len"].shape[0]
    kv = [cache[n] for n in KV_LEAVES if n in cache]
    T = kv[0].shape[2] if kv else 0
    per_pos = sum(t.numel() // (B * T) * t.element_size() for t in kv)
    state = sum(cache[n].numel() // B * cache[n].element_size() for n in STATE_LEAVES
                if n in cache)
    return per_pos, T, state


def lm_serving(cfg, params, reqs, first32, spec) -> dict:
    """The batcher in the config's own dtype, timed per prefill and per
    decode wave (host clock around work that ends in a synchronize).

    Each wave's bound is the bytes it must move over HBM: the weights (the
    embedding rows gathered, not the table), the active slots' valid KV and
    one KV position written per slot, the active slots' SSM states read and
    written, the logits.  A MoE config gets a second bound that reads only
    the experts its active slots' tokens route to (``moe_dense`` reads all
    of them); the routes are recorded per wave, off the timed work."""
    import numpy as np
    import torch

    from repro_torch.models import moe
    from repro_torch.serve.batcher import Batcher

    t_step = time.perf_counter()
    T_max = spec["serve_max_len"]
    weight_bytes = sum(p.numel() * p.element_size() for n, p in params.named_parameters()
                       if n != "embed")
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    b = Batcher(cfg, params, max_batch=spec["serve_max_batch"], max_len=T_max)
    kv_pos_bytes, T, state_bytes = cache_bytes(b.cache)
    expert_bytes = routes = None
    if cfg.family == "moe":
        w = params.layers[0].moe.w1
        expert_bytes = 3 * cfg.d_model * cfg.d_ff * w.element_size()
        routes, router_topk = [], moe.router_topk

        def recording_topk(x, router_w, top_k):
            idx, wts = router_topk(x, router_w, top_k)
            routes.append(idx)
            return idx, wts

        moe.router_topk = recording_topk
    finite = torch.ones((), dtype=torch.bool, device=params.device)
    prefills, waves = [], []
    prefill, decode = b.prefill, b.decode

    def timed_prefill(p, batch):
        nonlocal finite
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = prefill(p, batch)
        torch.cuda.synchronize()
        prefills.append((batch["tokens"].shape[1], time.perf_counter() - t0))
        finite = finite & torch.isfinite(logits).all()
        return cache, logits

    def timed_decode(p, cache, tokens):
        nonlocal finite
        clocks = cache["len"].tolist()  # synchronizes
        active = [i for i, s in enumerate(b.slots) if s is not None]
        if routes is not None:
            routes.clear()
        t0 = time.perf_counter()
        cache, logits = decode(p, cache, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        B = tokens.shape[0]
        kv = sum(min(clocks[i] + 1, T) for i in active) * kv_pos_bytes
        need = (weight_bytes + B * cfg.d_model * params.embed.element_size() + kv
                + B * kv_pos_bytes + 2 * len(active) * state_bytes
                + logits.numel() * logits.element_size())
        routed = need
        if routes is not None:  # the experts no active slot routes to are not read
            rows = torch.as_tensor(active, device=tokens.device)
            used = sum(int(torch.unique(idx.reshape(B, -1)[rows]).numel()) for idx in routes)
            routed = need - (cfg.n_experts * len(routes) - used) * expert_bytes
        waves.append((wall, need, routed, len(active)))
        finite = finite & torch.isfinite(logits).all()
        return cache, logits

    b.prefill, b.decode = timed_prefill, timed_decode
    for r in reqs:
        b.submit(r)
    t0 = time.perf_counter()
    try:
        b.run()
        torch.cuda.synchronize()
    finally:
        # the timed closures refer to b: put the batcher's own back, so that
        # no cycle keeps its cache and weights alive past this step
        b.prefill, b.decode = prefill, decode
        if routes is not None:
            moe.router_topk = router_topk
    wall = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError(f"lm_serve {cfg.name}: non-finite logits in the bf16 serving run")
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        raise AssertionError(f"lm_serve {cfg.name}: a request did not finish")
    peak = torch.cuda.max_memory_allocated()
    def wave():
        b.cache, _ = decode(params, b.cache, b.tokens)

    profile = device_profile(wave)
    deciles = []
    for part in np.array_split(np.array(sorted(prefills)), 10):
        if len(part):
            deciles.append({"prompt_tokens": [int(part[0, 0]), int(part[-1, 0])],
                            "requests": len(part), "ms_mean": float(part[:, 1].mean() * 1e3),
                            "tokens_per_s": float(part[:, 0].sum() / part[:, 1].sum())})
    wave_s = np.array([w[0] for w in waves])
    bound_s = np.array([w[1] for w in waves]) / HBM_BYTES_PER_S
    decoded = sum(w[3] for w in waves)
    generated = sum(len(r.out) for r in reqs)
    decode_line = {
        "waves": len(waves), "tokens": decoded, "seconds": float(wave_s.sum()),
        "tokens_per_s": decoded / float(wave_s.sum()),
        "ms_per_wave_mean": float(wave_s.mean() * 1e3),
        "ms_per_wave_median": float(np.median(wave_s) * 1e3),
        "bound_ms_per_wave_mean": float(bound_s.mean() * 1e3),
        "bound_share": float(bound_s.sum() / wave_s.sum()),
        "bound_by": "bytes: weights (embedding rows gathered, not the table) + the active "
                    "slots' valid KV + one KV position written per slot + the active "
                    "slots' SSM states read and written + logits",
    }
    if routes is not None:
        routed_s = np.array([w[2] for w in waves]) / HBM_BYTES_PER_S
        decode_line.update({
            "bound_ms_per_wave_mean_routed_experts": float(routed_s.mean() * 1e3),
            "bound_share_routed_experts": float(routed_s.sum() / wave_s.sum()),
            "bound_by_routed_experts": "the same bytes, reading only the experts the active "
                                       "slots' tokens route to in each layer"})
    line = {
        "phase": "lm_serve", "arch": cfg.name, "step": "serve", "card": nvidia_smi(),
        "dtype": cfg.dtype, "n_layers": cfg.n_layers, "requests": len(reqs),
        "prompt_tokens": [len(r.prompt) for r in reqs],
        "max_new": spec["serve_max_new"], "max_batch": spec["serve_max_batch"],
        "max_len": T_max, "kv_positions": T,
        "kv_cache_bytes": sum(b.cache[n].numel() * b.cache[n].element_size()
                              for n in KV_LEAVES if n in b.cache),
        "kv_bytes_per_slot": kv_pos_bytes * T, "state_bytes_per_slot": state_bytes,
        "weight_bytes_per_step": weight_bytes,
        "wall_s": wall, "generated_tokens": generated, "generated_tokens_per_s": generated / wall,
        "prefill": {"seconds": sum(s for _, s in prefills), "by_prompt_decile": deciles},
        "decode": decode_line,
        "decode_profile": profile,
        "allocated_at_start_bytes": at_start, "peak_mem_bytes": peak,
        "peak_mem_bytes_with_profile": torch.cuda.max_memory_allocated(),
        "first_token_equals_float32": sum(r.out[0] == f for r, f in zip(reqs, first32)) / len(reqs),
        "logits_finite": True, "seconds": time.perf_counter() - t_step,
    }
    emit(line)
    return line


def lm_greedy_batching(cfg, params, rng, spec) -> dict:
    """``greedy_generate`` on a batch of ``batch_requests`` requests (each
    with its own frontend embeddings and tokens) against each request
    alone: tokens exactly equal (the frontend families' counterpart of the
    batcher check; the reference's Batcher takes tokens only)."""
    import torch

    from repro_torch.serve.serve_step import greedy_generate

    t0 = time.perf_counter()
    B, S, new = spec["batch_requests"], spec["batch_prompt"], spec["batch_max_new"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=params.device)
    emb = frontend_embeds(cfg, spec, B, rng, params.device)
    max_len = S + new + n_prefix(cfg, emb)
    both = greedy_generate(cfg, params, {"tokens": toks, "embeds": emb}, steps=new,
                           max_len=max_len).tolist()
    for i in range(B):
        alone = greedy_generate(cfg, params, {"tokens": toks[i:i + 1], "embeds": emb[i:i + 1]},
                                steps=new, max_len=max_len)[0].tolist()
        if alone != both[i]:
            raise AssertionError(f"lm_serve {cfg.name}: request {i} batched {both[i]}, "
                                 f"alone {alone}")
    line = {"phase": "lm_serve", "arch": cfg.name, "step": "batching", "dtype": cfg.dtype,
            "requests": B, "prompt": S, "frontend_positions": emb.shape[1], "max_new": new,
            "via": "greedy_generate", "tokens_equal": True, "seconds": time.perf_counter() - t0}
    emit(line)
    return line


def lm_greedy_serving(cfg, params, rng, spec) -> dict:
    """Greedy generation in the config's own dtype over one batch of
    ``serve_batch`` requests per text length of ``serve_text``, each with
    its frontend embeddings, ``serve_max_new`` tokens each; prefill and
    every decode step timed on the host clock around synchronized work.

    A decode step's bound is the bytes it must move over HBM: the weights
    (the embedding rows gathered, not the table), every slot's valid self
    K/V and one position written, the enc-dec's cross K/V (read whole at
    every step) and the logits."""
    import numpy as np
    import torch

    from repro_torch.serve.serve_step import make_decode, make_prefill

    t_step = time.perf_counter()
    dev = params.device
    B, new = spec["serve_batch"], spec["serve_max_new"]
    weight_bytes = sum(p.numel() * p.element_size() for n, p in params.named_parameters()
                       if n != "embed")
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    decode = make_decode(cfg)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    batches, steps = [], []
    t0 = time.perf_counter()
    for n_text in spec["serve_text"]:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, n_text)), device=dev)
        emb = frontend_embeds(cfg, spec, B, rng, dev)
        pre = n_prefix(cfg, emb)
        torch.cuda.synchronize()
        tp = time.perf_counter()
        cache, logits = make_prefill(cfg, pre + n_text + new)(params, {"tokens": toks,
                                                                       "embeds": emb})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - tp
        self_kv = [cache[n] for n in ("k", "v", "self_k", "self_v") if n in cache]
        pos_bytes = sum(t[:, 0, 0].numel() * t.element_size() for t in self_kv)  # one slot
        cross_bytes = sum(cache[n].numel() * cache[n].element_size()
                          for n in ("cross_k", "cross_v") if n in cache)
        tok = torch.argmax(logits, dim=-1)[:, None]
        walls, need = [], []
        for i in range(new):
            torch.cuda.synchronize()
            ts_ = time.perf_counter()
            cache, logits = decode(params, cache, tok)
            tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - ts_)
            valid = pre + n_text + i + 1  # positions read after this step's write
            need.append(weight_bytes + B * cfg.d_model * params.embed.element_size()
                        + B * (valid + 1) * pos_bytes + cross_bytes
                        + logits.numel() * logits.element_size())
            finite = finite & torch.isfinite(logits).all()
        steps.extend(zip(walls, need))
        batches.append({"text_tokens": n_text, "frontend_positions": emb.shape[1],
                        "prompt_positions": pre + n_text, "prefill_ms": prefill_s * 1e3,
                        "prefill_tokens_per_s": B * (pre + n_text) / prefill_s,
                        "decode_ms_per_step_mean": float(np.mean(walls) * 1e3),
                        "bound_ms_per_step_mean": float(np.mean(need) / HBM_BYTES_PER_S * 1e3),
                        "cross_kv_bytes": cross_bytes})
    wall = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError(f"lm_serve {cfg.name}: non-finite logits in the serving run")
    peak = torch.cuda.max_memory_allocated()

    def step():
        nonlocal cache
        cache, _ = decode(params, cache, tok)

    profile = device_profile(step)
    wave_s = np.array([w for w, _ in steps])
    bound_s = np.array([n for _, n in steps]) / HBM_BYTES_PER_S
    generated = len(spec["serve_text"]) * B * new
    line = {
        "phase": "lm_serve", "arch": cfg.name, "step": "serve", "card": nvidia_smi(),
        "dtype": cfg.dtype, "n_layers": cfg.n_layers, "via": "greedy_generate steps",
        "batch": B, "max_new": new, "batches": batches,
        "weight_bytes_per_step": weight_bytes, "wall_s": wall,
        "generated_tokens": generated, "generated_tokens_per_s": generated / wall,
        "decode": {"steps": len(steps), "tokens_per_s": B * len(steps) / float(wave_s.sum()),
                   "ms_per_step_mean": float(wave_s.mean() * 1e3),
                   "ms_per_step_median": float(np.median(wave_s) * 1e3),
                   "bound_ms_per_step_mean": float(bound_s.mean() * 1e3),
                   "bound_share": float(bound_s.sum() / wave_s.sum()),
                   "bound_by": "bytes: weights (embedding rows gathered, not the table) + "
                               "every slot's valid self K/V + one position written + the "
                               "cross K/V read whole (enc-dec) + logits"},
        "prefill_s": sum(b["prefill_ms"] for b in batches) / 1e3,
        "decode_profile": profile,
        "allocated_at_start_bytes": at_start, "peak_mem_bytes": peak,
        "peak_mem_bytes_with_profile": torch.cuda.max_memory_allocated(),
        "logits_finite": True, "seconds": time.perf_counter() - t_step,
    }
    emit(line)
    return line


def device_profile(step, waves: int = 3, top: int = 8) -> dict:
    """``torch.profiler`` over ``waves`` calls of ``step`` (a full-width
    decode wave, or a train step): device time by kernel per call, and the
    device's busy share of the traced window (its kernels' time over its
    wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(waves):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the device's own events (kernels, copies, memsets), not the host ops
    # that launched them
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(device_us(e) for e in kernels)
    kernels.sort(key=device_us, reverse=True)
    return {
        "waves": waves, "wall_ms_per_wave": wall_us / waves / 1e3,
        "device_ms_per_wave": total / waves / 1e3 if kernels else "not measured",
        "device_busy_share": total / wall_us if kernels else "not measured",
        "kernels_per_wave": sum(e.count for e in kernels) / waves,
        "top": [{"name": e.key[:120], "ms_per_wave": device_us(e) / waves / 1e3,
                 "calls_per_wave": e.count / waves} for e in kernels[:top]],
    }


def lm_sdpa_yardstick(cfg, S, gen) -> dict:
    """One prefill attention call at S tokens: the port's flash against
    ``scaled_dot_product_attention`` (a yardstick only; never on the path)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.layers import attention

    dt = getattr(torch, cfg.dtype)

    def rand(h):
        return torch.randn((1, S, h, cfg.head_dim), generator=gen, device=DEVICE).to(dt)

    q, k, v = rand(cfg.n_heads), rand(cfg.n_kv), rand(cfg.n_kv)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def flash():
        return attention(q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    diff = float((flash().float() - sdpa().transpose(1, 2).float()).abs().max())
    flash_ms, sdpa_ms = cuda_ms(flash, REPS), cuda_ms(sdpa, REPS)
    ops = 4 * cfg.n_heads * cfg.head_dim * (S * (S + 1) // 2)  # QK and PV over causal pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_TENSOR_OPS_PER_S * 1e3
    line = {"phase": "lm_serve", "arch": cfg.name, "step": "sdpa_yardstick", "S": S,
            "dtype": cfg.dtype,
            "heads": [cfg.n_heads, cfg.n_kv], "head_dim": cfg.head_dim,
            "flash_ms": flash_ms, "sdpa_ms": sdpa_ms, "max_abs_diff": diff,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit(line)
    return line


def phase_lm_serve(seed: int, spec: dict) -> list:
    """One family's serving path (``repro_torch.models``,
    ``repro_torch.serve``) at ``spec["arch"]``'s published size, weights
    from ``seed``: card against CPU and teacher forcing in float32, the
    family's own check (``moe_dispatch``, ``scan``), the continuous batcher
    against unbatched generation in float32 (tokens exactly equal), then
    the batcher timed in the config's dtype, and for the dense decoder the
    flash-attention yardstick.  The stub-frontend families (VLM, enc-dec)
    carry their embeddings through every step and serve through
    ``greedy_generate`` (``lm_greedy_batching``, ``lm_greedy_serving``).
    No kernel of the repo is on this path; the launch counters are set to
    0 before it and read after."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serve.batcher import Request

    t_phase = time.perf_counter()
    gc.collect()  # no earlier phase's garbage in this family's memory figures
    torch.cuda.empty_cache()
    reset_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(seed)
    cfg32 = get_config(spec["arch"], smoke=spec["smoke"], dtype="float32")
    cfg = get_config(spec["arch"], smoke=spec["smoke"])
    params32 = model.init_params(cfg32, seed, device=DEVICE)
    lines = [lm_card_vs_cpu(cfg32, params32, rng, spec, seed),
             lm_teacher_forcing(cfg32, params32, rng, spec)]
    if cfg.frontend != "none":
        lines.append(lm_greedy_batching(cfg32, params32, rng, spec))
        del params32
        torch.cuda.empty_cache()
        params = model.init_params(cfg, seed, device=DEVICE)
        lines.append(lm_greedy_serving(cfg, params, rng, spec))
        del params
        torch.cuda.empty_cache()
        return lm_serve_done(cfg, lines, t_phase)
    if "moe_dispatch_tokens" in spec:
        lines.append(lm_moe_dispatch(cfg32, params32, rng, spec))
    if "scan_len" in spec:
        lines.append(lm_scan(cfg32, params32, rng, spec))
    lines.append(lm_batching(cfg32, params32, rng, spec))
    lens = [int(x) for x in rng.integers(spec["serve_prompt"][0], spec["serve_prompt"][1] + 1,
                                         spec["serve_requests"])]
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), spec["serve_max_new"])
            for i, n in enumerate(lens)]
    first32 = lm_first_tokens(cfg32, params32, [r.prompt for r in reqs])
    # the same draws in the config's dtype: the float32 weights, cast
    params = model.init_params(cfg, seed, device=DEVICE)
    if not torch.equal(params.lm_head, params32.lm_head.to(params.lm_head.dtype)):
        raise AssertionError(f"lm_serve {cfg.name}: the bf16 weights are not the float32 "
                             "weights cast")
    del params32
    torch.cuda.empty_cache()
    lines.append(lm_serving(cfg, params, reqs, first32, spec))
    del params
    torch.cuda.empty_cache()
    if "sdpa_len" in spec:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        lines.append(lm_sdpa_yardstick(cfg, spec["sdpa_len"], gen))
    return lm_serve_done(cfg, lines, t_phase)


def lm_serve_done(cfg, lines, t_phase) -> list:
    lines.append({"phase": "lm_serve", "arch": cfg.name, "step": "done",
                  "launches": read_counts(), "seconds": time.perf_counter() - t_phase})
    emit(lines[-1])
    if any(lines[-1]["launches"].values()):
        raise AssertionError(f"lm_serve {cfg.name}: a kernel of the MSJ path launched on the "
                             "serving path")
    return lines


# --------------------------------------------------------------------------
# phase 10: training (the SGF-filtered corpus, then AdamW steps of qwen3)
# --------------------------------------------------------------------------

#: the ``train`` phase's sizes: the pipeline's crawl shard, the training
#: config and its batches (qwen3-0.6b at its published config; the batch is
#: the config's ``train_microbatches`` of 4 sequences of 4096 tokens)
TRAIN = {"corpus_log2_docs": 24, "P": 16, "strategy": "one_round",
         "arch": "qwen3-0.6b", "grad_layers": 2, "grad_tokens": 128, "flash_len": 2048,
         "batch": 8, "seq": 4096, "steps": 4,
         "restart_batch": 4, "restart_seq": 2048, "restart_steps": 4, "restart_every": 2,
         "restart_crash_at": 3}
GRAD_TOL = 1e-3  # max |Δg| / max |g| per leaf, card against CPU, float32 without TF32
FLASH_GRAD_TOL = 1e-3  # max |Δg| / max |g|, the flash backward against dense autograd
RESTART_LOSS_TOL = 1e-3  # relative: the card's embedding backward sums with atomics
#: |step-1 loss - transformer.expected_initial_loss|: ln(V) + σ²/2 with
#: σ² = d · 0.02² (0.41 for qwen3)
INIT_LOSS_TOL = 0.1


def corpus_oracle(rels):
    """The Keep query's doc ids by numpy set membership."""
    import numpy as np

    docs = rels["Docs"]
    dup, blocked, quality = (rels[k][:, 0] for k in ("Dup", "Blocked", "Quality"))
    keep = (~np.isin(docs[:, 2], dup) & ~np.isin(docs[:, 3], dup)
            & ~np.isin(docs[:, 1], blocked) & np.isin(docs[:, 0], quality))
    return np.sort(docs[keep, 0]).astype(np.int64)


def train_corpus(seed, spec) -> tuple:
    """The Keep query's crawl shard (``data.synthetic.corpus_relations``)
    and its numpy oracle, with the seconds each took: ``(rels, want,
    data_s, oracle_s)``."""
    from repro_torch.data import synthetic

    t0 = time.perf_counter()
    rels = synthetic.corpus_relations(2 ** spec["corpus_log2_docs"], seed=seed)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = corpus_oracle(rels)
    return rels, want, data_s, time.perf_counter() - t0


def train_pipeline(spec, corpus):
    """The Keep query over a 2**24-document crawl shard (``corpus``, from
    :func:`train_corpus`) on the card through ``data.pipeline.filter_corpus``
    (counters set to 0 just before, read just after: the probe kernel must
    have launched, bloom not), held to a numpy oracle, and the same plan's
    outputs and per-job counters bit-identical to ``probe_backend="sorted"``.
    Returns the kept ids and the line."""
    import numpy as np
    import torch

    from repro_torch.core.relation import db_from_dict
    from repro_torch.data import pipeline
    from repro_torch.obs.tracer import Tracer

    P, strategy = spec["P"], spec["strategy"]
    rels, want, data_s, oracle_s = corpus
    pipeline.filter_corpus(rels, P=P, strategy=strategy, device=DEVICE)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    kept, summary = pipeline.filter_corpus(rels, P=P, strategy=strategy, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(kept.cpu().numpy(), want):
        raise AssertionError("train pipeline: the kept ids differ from the numpy oracle")
    db = db_from_dict(rels, P=P, device=DEVICE)
    plan = pipeline.plan_for(db, strategy)
    env_a, rep_a, wall_a = run_plan(db, plan, P, "auto")
    backends = check_path_kernels("train pipeline", rep_a, launches, False)
    if any(launches[k] for k in ("bloom_build", "bloom_pack", "bloom_probe")):
        raise AssertionError(f"train pipeline: a bloom kernel launched: {launches}")
    env_s, rep_s, wall_s = run_plan(db, plan, P, "sorted")
    same_outputs(env_a, env_s, ["Keep"])
    if [r.stats for r in rep_a.records] != [r.stats for r in rep_s.records]:
        raise AssertionError("train pipeline: auto and sorted counters differ")
    if not torch.equal(pipeline.kept_ids(env_a["Keep"]), kept):
        raise AssertionError("train pipeline: filter_corpus and execute_plan differ")
    del env_a, env_s
    _, rep_t, wall_t = run_plan(db, plan, P, "auto", tracer=Tracer(trace_sync=True))
    del db
    line = {"phase": "train", "step": "pipeline", "card": nvidia_smi(),
            "docs": len(rels["Docs"]), "relations": {k: list(v.shape) for k, v in rels.items()},
            "P": P, "strategy": strategy, "kept": int(kept.numel()), "oracle_equal": True,
            "bit_identical_to_sorted": True, "jobs": summary["jobs"], "msj_backends": backends,
            "probe_wrapper": "probe_bucketed", "launches": launches, "wall_s": wall,
            "wall_auto_s": wall_a, "wall_sorted_s": wall_s, "traced_wall_s": wall_t,
            "phase_s": phase_seconds(rep_t), "bytes_shuffled": summary["bytes_shuffled"],
            "input_rows": summary["input_rows"],
            "forward_cap": [r.stats.get("forward_cap") for r in rep_a.records],
            "peak_mem_bytes": peak, "corpus_s": data_s, "oracle_s": oracle_s}
    emit(line)
    return kept, line


def grad_tree(params) -> list:
    return [p.grad.detach().cpu() for p in params.parameters()]


def train_grad_card_vs_cpu(seed, spec) -> dict:
    """qwen3-0.6b at full width, depth cut to ``grad_layers``: loss and
    every parameter's gradient on the card against the CPU, float32 with
    TF32 off, the same weights and tokens."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.models import model

    t0 = time.perf_counter()
    full = get_config(spec["arch"], dtype="float32")
    cfg = dataclasses.replace(full, n_layers=spec["grad_layers"])
    card = model.init_params(cfg, seed, device=DEVICE).requires_grad_(True)
    cpu = model.params_from_numpy(cfg, model.params_to_numpy(card), device="cpu")
    cpu.requires_grad_(True)
    out = {}
    for where, p in (("card", card), ("cpu", cpu)):
        batch = synthetic.token_batch(cfg, "train", 1, spec["grad_tokens"], 0, seed=seed,
                                      device=p.device)
        loss = model.loss_fn(cfg, p, batch)
        loss.backward()
        out[where] = (float(loss.detach()), grad_tree(p))
    names = [n for n, _ in card.named_parameters()]
    errs = {n: float((g - w).abs().max() / w.abs().max())
            for n, g, w in zip(names, out["card"][1], out["cpu"][1])}
    worst = max(errs, key=errs.get)
    loss_err = abs(out["card"][0] - out["cpu"][0]) / out["cpu"][0]
    del card, cpu, out
    line = {"phase": "train", "step": "grad_card_vs_cpu", "arch": cfg.name, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "reduced": {"n_layers": [cfg.n_layers, full.n_layers]},
            "tokens": spec["grad_tokens"], "loss_rel_err": loss_err, "leaves": len(errs),
            "worst_leaf": worst, "worst_rel_err": errs[worst], "tol": GRAD_TOL,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if not (errs[worst] <= GRAD_TOL and loss_err <= GRAD_TOL):
        raise AssertionError(f"train: card and CPU gradients differ: {line}")
    return line


def train_flash_grad(seed, spec) -> dict:
    """The flash backward at ``flash_len`` tokens (qwen3's heads, causal)
    against autograd through a dense masked softmax, float32 on the card;
    then the flash forward + backward timed in bf16 beside
    ``scaled_dot_product_attention``'s (the yardstick, never on the path)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models.flash import flash_attention

    cfg = get_config(spec["arch"])
    S, D, Hkv, G = spec["flash_len"], cfg.head_dim, cfg.n_kv, cfg.n_heads // cfg.n_kv
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype).requires_grad_(True)

    q, k, v = rand(1, Hkv, G, S, D), rand(1, Hkv, S, D), rand(1, Hkv, S, D)
    do = torch.randn((1, Hkv, G, S, D), generator=gen, device=DEVICE)
    got = torch.autograd.grad(
        flash_attention(q, k, v, True, 0, 0, cfg.q_chunk, cfg.kv_chunk), (q, k, v), do)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k) / D ** 0.5
    causal = torch.ones((S, S), dtype=torch.bool, device=DEVICE).tril()
    o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s.masked_fill(~causal, -1e30), -1), v)
    want = torch.autograd.grad(o, (q, k, v), do)
    errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    del s, o, want, got

    bf = torch.bfloat16
    qb, kb, vb = (t.detach().to(bf).requires_grad_(True) for t in (q, k, v))
    dob = do.to(bf)
    qs, ks, vs = (t.detach().reshape(1, -1, S, D).requires_grad_(True) for t in (qb, kb, vb))
    dos = dob.reshape(1, -1, S, D)

    def flash():
        o = flash_attention(qb, kb, vb, True, 0, 0, cfg.q_chunk, cfg.kv_chunk)
        return torch.autograd.grad(o, (qb, kb, vb), dob)

    def sdpa():
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(o, (qs, ks, vs), dos)

    torch.cuda.reset_peak_memory_stats()
    flash_ms = cuda_ms(flash, 5)
    flash_peak = torch.cuda.max_memory_allocated()
    sdpa_ms = cuda_ms(sdpa, 5)
    H = Hkv * G
    pairs = S * (S + 1) // 2
    ops = 6 * 2 * H * D * pairs  # QK, PV; dV, dP, dQ, dK over causal pairs
    nbytes = 2 * sum(t.numel() * t.element_size() for t in (qb, kb, vb, dob))  # in + grads out
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_TENSOR_OPS_PER_S * 1e3
    line = {"phase": "train", "step": "flash_grad", "card": nvidia_smi(), "S": S,
            "heads": [H, Hkv], "head_dim": D, "chunks": [cfg.q_chunk, cfg.kv_chunk],
            "rel_err_dq_dk_dv": errs, "tol": FLASH_GRAD_TOL, "dtype_check": "float32",
            "dtype_timed": "bfloat16", "flash_fwd_bwd_ms": flash_ms,
            "sdpa_fwd_bwd_ms": sdpa_ms, "flash_peak_mem_bytes": flash_peak,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit(line)
    if not max(errs) <= FLASH_GRAD_TOL:
        raise AssertionError(f"train: the flash backward differs from dense autograd: {errs}")
    return line


def kept_batch_fn(cfg, kept, batch, seq):
    """Batches seeded from the pipeline's kept ids, as the reference's
    ``examples/train_lm.py`` seeds them."""
    import numpy as np

    from repro_torch.data import synthetic

    def batch_fn(step):
        rng = np.random.default_rng(np.random.SeedSequence([7, step]))
        seeds = rng.choice(kept, size=batch)
        return synthetic.token_batch(cfg, "train", batch, seq, step, seed=int(seeds[0]),
                                     device=DEVICE)

    return batch_fn


def train_steps(seed, spec, kept) -> dict:
    """qwen3-0.6b whole at its published config: float32 parameters and
    moments, bf16 compute, ``remat="full"``, ``batch`` x ``seq`` tokens in
    the config's microbatches; each step timed on the host clock around
    synchronized work, TF32 off (torch's default); then one step traced by
    the profiler and one timed with TF32 allowed."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import optimizer, train_step as ts

    cfg = get_config(spec["arch"])
    opt_cfg = optimizer.OptConfig(lr=3e-4, warmup_steps=2, total_steps=spec["steps"])
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_state(cfg, seed, opt_cfg, device=DEVICE)
    n_params = sum(p.numel() for p in state["params"].parameters())
    state_bytes = torch.cuda.memory_allocated()
    step_fn = ts.make_train_step(cfg, opt_cfg, microbatches=cfg.train_microbatches)
    batch_fn = kept_batch_fn(cfg, kept, spec["batch"], spec["seq"])
    losses, walls = [], []
    for i in range(spec["steps"]):
        batch = batch_fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # synchronizes
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    batch = batch_fn(spec["steps"])

    def one_step():
        nonlocal state
        state, _ = step_fn(state, batch)

    profile = device_profile(one_step, waves=1, top=10)  # one more step, traced
    # and one with TF32 allowed: the flash backward's float32 einsums (the
    # reference's casts) then run on the tensor cores; a user's setting, not
    # the port's, timed beside the default
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        tf32_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    finite = all(math.isfinite(x) for x in losses) and all(
        bool(torch.isfinite(p).all()) for p in state["params"].parameters())
    del state
    tokens = spec["batch"] * spec["seq"]
    step_s = sum(walls[1:]) / len(walls[1:])  # the first step warms up
    flops = 6 * n_params * tokens
    line = {"phase": "train", "step": "train", "arch": cfg.name, "card": nvidia_smi(),
            "params": n_params, "param_dtype": "float32", "compute_dtype": cfg.dtype,
            "remat": cfg.remat, "batch": spec["batch"], "seq": spec["seq"],
            "microbatches": cfg.train_microbatches, "losses": losses,
            "ln_vocab": math.log(cfg.vocab),
            "expected_initial_loss": transformer.expected_initial_loss(cfg),
            "finite": finite, "step_s": walls,
            "step_ms_steady": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "model_flops_per_step": flops,
            "bf16_peak_share": flops / step_s / BF16_TENSOR_OPS_PER_S,
            "state_bytes": state_bytes, "peak_mem_bytes": peak,
            "step_profile": profile, "step_ms_with_tf32": tf32_s * 1e3}
    emit(line)
    if not finite:
        raise AssertionError(f"train: non-finite loss or parameters: {losses}")
    if not abs(losses[0] - line["expected_initial_loss"]) <= INIT_LOSS_TOL:
        raise AssertionError(f"train: step-1 loss {losses[0]} is not near ln(V) + σ²/2 = "
                             f"{line['expected_initial_loss']}")
    return line


def train_restart(seed, spec, kept) -> dict:
    """``run_train_loop`` crashed at ``restart_crash_at`` (checkpoints every
    ``restart_every`` steps into a temporary directory), then resumed: the
    state it loads must be bit for bit the state that was saved, and the
    resumed losses within ``RESTART_LOSS_TOL`` of an uninterrupted run."""
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.ft import supervisor
    from repro_torch.train import optimizer, train_step as ts

    cfg = get_config(spec["arch"])
    n, every, crash = spec["restart_steps"], spec["restart_every"], spec["restart_crash_at"]
    opt_cfg = optimizer.OptConfig(lr=3e-4, warmup_steps=1, total_steps=n)
    step_fn = ts.make_train_step(cfg, opt_cfg, microbatches=cfg.train_microbatches)
    batch_fn = kept_batch_fn(cfg, kept, spec["restart_batch"], spec["restart_seq"])
    timed = {"save_s": [], "load_s": []}
    save, load = checkpoint.save, checkpoint.load

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        out = save(*a, **k)
        timed["save_s"].append(time.perf_counter() - t0)
        return out

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        out = load(*a, **k)
        torch.cuda.synchronize()
        timed["load_s"].append(time.perf_counter() - t0)
        return out

    def leaves(state):
        return ([state["opt"]["step"]] + [t for m in (state["params"], state["opt"]["mu"],
                                                      state["opt"]["nu"])
                                          for t in m.parameters()])

    saved = {}

    def recording_step(state, batch):  # keeps the state the step-2 checkpoint holds
        state, metrics = step_fn(state, batch)
        if int(state["opt"]["step"]) == every:
            saved["leaves"] = [t.detach().clone() for t in leaves(state)]
        return state, metrics

    resumed = {}

    def checking_step(state, batch):  # compares the loaded state on the first call
        if "equal" not in resumed:
            resumed["equal"] = len(leaves(state)) == len(saved["leaves"]) and all(
                torch.equal(a, b) for a, b in zip(leaves(state), saved["leaves"]))
            saved.clear()
        return step_fn(state, batch)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    checkpoint.save, checkpoint.load = timed_save, timed_load
    t0 = time.perf_counter()
    try:
        free_before = shutil.disk_usage(tmp).free
        state = ts.init_state(cfg, seed, opt_cfg, device=DEVICE)
        try:
            supervisor.run_train_loop(state, recording_step, batch_fn, steps=n, ckpt_dir=tmp,
                                      ckpt_every=every, crash_at=crash, log_every=1)
            raise AssertionError("train restart: the injected crash did not happen")
        except supervisor.SimulatedFault:
            pass
        del state
        latest = checkpoint.latest_step(tmp)
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp, f"step_{latest:08d}").iterdir())
        # a fresh state (other weights), replaced by the checkpoint's
        _, hist = supervisor.run_train_loop(ts.init_state(cfg, seed + 1, opt_cfg, device=DEVICE),
                                            checking_step, batch_fn, steps=n, ckpt_dir=tmp,
                                            ckpt_every=every, log_every=1)
        state = ts.init_state(cfg, seed, opt_cfg, device=DEVICE)
        straight = []
        for i in range(n):
            state, m = step_fn(state, batch_fn(i))
            straight.append(float(m["loss"]))
        del state
    finally:
        checkpoint.save, checkpoint.load = save, load
        shutil.rmtree(tmp, ignore_errors=True)
    got = {s: loss for s, loss in hist}
    errs = {s: abs(got[s] - straight[s - 1]) / straight[s - 1] for s in got}
    line = {"phase": "train", "step": "restart", "arch": cfg.name,
            "batch": spec["restart_batch"], "seq": spec["restart_seq"], "steps": n,
            "ckpt_every": every, "crash_at": crash, "resumed_from": latest,
            "loaded_state_bit_identical": resumed.get("equal", False),
            "resumed_losses": got, "uninterrupted_losses": straight, "loss_rel_err": errs,
            "tol": RESTART_LOSS_TOL, "checkpoint_bytes": ckpt_bytes, "free_disk_bytes":
            free_before, **timed, "seconds": time.perf_counter() - t0}
    emit(line)
    if not (line["loaded_state_bit_identical"] and sorted(got) == list(range(latest + 1, n + 1))
            and all(e <= RESTART_LOSS_TOL for e in errs.values())):
        raise AssertionError(f"train restart failed: {line}")
    return line


def phase_train(seed: int, spec: dict, corpus) -> list:
    """The training path: the SGF-filtered corpus (``corpus``, a future of
    :func:`train_corpus`; the probe kernel on the path), gradients card
    against CPU, the flash backward, AdamW steps of qwen3-0.6b whole, and a
    crash and restart from a checkpoint."""
    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kept, pipe = train_pipeline(spec, corpus.result())
    kept = kept.cpu().numpy()
    torch.cuda.empty_cache()
    reset_counts()
    lines = [pipe, train_grad_card_vs_cpu(seed, spec), train_flash_grad(seed, spec)]
    torch.cuda.empty_cache()
    lines.append(train_steps(seed, spec, kept))
    torch.cuda.empty_cache()
    lines.append(train_restart(seed, spec, kept))
    torch.cuda.empty_cache()
    lines.append({"phase": "train", "step": "done", "launches_after_pipeline": read_counts(),
                  "seconds": time.perf_counter() - t_phase})
    emit(lines[-1])
    if any(lines[-1]["launches_after_pipeline"].values()):
        raise AssertionError("train: a kernel of the MSJ path launched on the model path")
    return lines


# --------------------------------------------------------------------------
# phase 11: the multi-card layer
# --------------------------------------------------------------------------

#: the mesh phase: (a) the A3 MSJ stages at 2**msj_log2_rows rows, P =
#: msj_P gloo ranks on the one card, then P = 1 over NCCL; (b) qwen3-0.6b
#: whole on the (1, 1) NCCL mesh with the train phase's batch; (c) four
#: gloo ranks on (2, 2), qwen3-0.6b at its width with four_layers layers;
#: (d) the same four ranks, the SSM, hybrid and enc-dec families
#: tensor-parallel (MESH_TP_TRAIN, MESH_TP_SERVE)
MESH = {"msj_log2_rows": 24, "msj_P": 4, "train_steps": 2,
        "four_layers": 2, "four_batch": 4, "four_seq": 1024, "four_steps": 2,
        "ranks_timeout_s": 500, "collective_timeout_s": 300}  # the ranks took 62.5 s
MESH_TOL = 1e-5  # relative, 4 gloo ranks to 1: losses, grad norms; parameters per leaf in |Δ|₂
#: mesh_train_4's peak per rank when every weight was gathered whole (this
#: phase on an NVIDIA H100 80GB HBM3 at 700 W, before per-layer gathers and
#: tensor parallelism): each rank's peak must stay below it
MESH_TRAIN_4_WHOLE_GATHER_PEAK = 5_006_349_824
#: (d) training: falcon-mamba-7b at its published width (d_model 4096,
#: d_inner 8192, N 16, vocabulary 65,024), 2 of its 64 layers, float32.
#: The parameters are held over the elements that one rank repeats
#: (:func:`twin_compare`): the zero-initialized ``conv_b`` is small after
#: two steps (about 2·lr·√n in |·|₂), and one rank alone moves it by
#: 1.06e-5 in |Δ|₂/|p|₂ between 1 and 2 microbatches at SMOKE width
MESH_TP_TRAIN = {"arch": "falcon-mamba-7b", "layers": 2, "batch": 4, "seq": 1024, "steps": 2}
#: its peak per rank when each layer was gathered whole over ``model`` and
#: every rank scanned all of d_inner (``--mesh-tp-only PORT_SRC`` on the
#: tree before these families computed tensor-parallel; NVIDIA H100 80GB
#: HBM3, 700 W): each rank's peak must stay below it
MESH_TP_TRAIN_LAYER_GATHER_PEAK = 12_660_265_984
#: (d) serving at each family's width, float32: a sharded prefill of
#: ``batch`` prompts of ``prompt`` tokens (seamless: and ``frames`` stub
#: frames), then ``decode`` steps of given tokens
MESH_TP_SERVE = [
    {"arch": "zamba2-7b", "overrides": {"n_layers": 6}, "batch": 4, "prompt": 512,
     "decode": 8},  # one group of 6 Mamba-2 layers and the shared block, no tail
    {"arch": "seamless-m4t-medium", "overrides": {"n_layers": 4, "enc_layers": 2,
                                                  "dec_layers": 2},
     "batch": 4, "prompt": 256, "frames": 256, "decode": 8},
]
SHARDED_TOL = 1e-6  # relative |Δ|₂ per leaf, (1, 1) mesh against no mesh, if not bit-identical


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_rank_setup(rank: int, port: int, world: int) -> None:
    """One of ``world`` gloo ranks on the one card (NCCL refuses two ranks
    on one device; gloo stages card tensors through the host)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=MESH["collective_timeout_s"]))


def spawn_ranks(fn, args, n: int) -> float:
    """``fn(rank, *args)`` in ``n`` spawned processes; kills them and
    raises if they have not all finished within ``MESH["ranks_timeout_s"]``.
    Returns the seconds they took."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.spawn(fn, args=args, nprocs=n, join=False)
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > MESH["ranks_timeout_s"]:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"mesh: the {n} ranks did not finish within "
                                 f"{MESH['ranks_timeout_s']} s")
    return time.perf_counter() - t0


def a3_semijoins():
    from repro_torch.core import queries
    from repro_torch.core.algebra import semijoins_of

    qs = queries.make_queries("A3")
    return qs, [sj for q in qs for sj in semijoins_of(q)]


def msj_stages(db, sjs, comm, cap):
    """The A3 job's map, probe and out stages (``_MSJKit``, the probe
    kernel as ``probe_fn``) at forward capacity ``cap``."""
    from repro_torch.core import msj
    from repro_torch.kernels.msj_probe import ops

    kit = msj._MSJKit(db, msj.make_spec(sjs), comm, cap, probe_fn=ops.probe_bucketed)
    return kit, [kit.stage_map, kit.stage_probe, kit.stage_out]


def result_tensors(result) -> list:
    """An MSJ pipeline result's tensors in a fixed order."""
    outputs, stats = result
    return ([t for k in sorted(outputs) for t in (outputs[k].data, outputs[k].valid)]
            + [stats[k] for k in sorted(stats)])


def path_launches(name, launches) -> None:
    """The probe kernel and both of its kernels launched on the path."""
    idle = [k for k in ("probe_bucketed", "table_build", "table_probe") if launches[k] <= 0]
    if idle:
        raise AssertionError(f"{name}: kernels of the path never launched: {idle}")
    check_probe_launches(name, launches, "probe_bucketed")


def mesh_msj_rank(rank, tmp, cap, P) -> dict:
    """Part (a), one rank: the stages on its shard under ``MeshComm``, once
    warm and once with the launch counters from 0, against its shard of
    the ``SimComm`` run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.relation import db_from_dict
    from repro_torch.engine.comm import MeshComm, run_pipeline
    from repro_torch.launch.mesh import AXES

    _, sjs = a3_semijoins()
    db_np = {p.stem[3:]: np.load(p) for p in Path(tmp).glob("db_*.npy")}
    db = db_from_dict(db_np, P=P, device=DEVICE)
    comm = MeshComm(init_device_mesh(torch.device(DEVICE).type, (P, 1), mesh_dim_names=AXES),
                    "data")
    kit, stages = msj_stages(db, sjs, comm, cap)
    run_pipeline(comm, stages, kit.stacked)  # warm
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    got = run_pipeline(comm, stages, kit.stacked)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = torch.load(Path(tmp) / f"want{rank}.pt")
    mine = [t.cpu() for t in result_tensors(got)]
    equal = len(mine) == len(want) and all(torch.equal(a, b) for a, b in zip(mine, want))
    return {"rank": rank, "shard": comm.shard_id(), "bit_identical": equal, "wall_s": wall,
            "peak_mem_bytes": peak, "launches": launches}


def mesh_rank(rank, port, tmp, cap, P, seed):
    """One of the P gloo ranks: part (a), then parts (c) and (d)."""
    import torch
    import torch.distributed as dist

    mesh_rank_setup(rank, port, P)
    out = {"msj": mesh_msj_rank(rank, tmp, cap, P)}
    gc.collect()
    torch.cuda.empty_cache()
    out["train_4"] = mesh_train4_rank(rank, tmp, seed, dict(
        arch=TRAIN["arch"], layers=MESH["four_layers"], batch=MESH["four_batch"],
        seq=MESH["four_seq"], steps=MESH["four_steps"]), checkpoints=True)
    out.update(mesh_tp_parts(rank, tmp, seed, serve=True))
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def mesh_tp_parts(rank, tmp, seed, serve: bool) -> dict:
    """Part (d) on one of the four ranks: its training, and with ``serve``
    its serving."""
    import torch

    out = {"tp_serve": []}
    gc.collect()
    torch.cuda.empty_cache()
    out["tp_train"] = mesh_train4_rank(rank, tmp, seed, MESH_TP_TRAIN, checkpoints=False)
    for spec in MESH_TP_SERVE if serve else ():
        gc.collect()
        torch.cuda.empty_cache()
        out["tp_serve"].append(mesh_tp_serve_rank(rank, tmp, seed, spec))
    return out


def mesh_tp_rank(rank, port, tmp, seed, serve: bool) -> None:
    """One of four gloo ranks of ``--mesh-tp-only``: part (d) alone."""
    import torch.distributed as dist

    mesh_rank_setup(rank, port, 4)
    out = mesh_tp_parts(rank, tmp, seed, serve)
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def mesh_tp_only(seed: int, port_src: str | None) -> int:
    """``--mesh-tp-only``: part (d) of the mesh phase alone, its line and
    checks; with ``port_src`` (another checkout's ``src``) only its
    training, on that port, and each rank's peak printed (how
    ``MESH_TP_TRAIN_LAYER_GATHER_PEAK`` is read on an older tree)."""
    import shutil
    import tempfile

    if port_src:
        os.environ[PORT_SRC_ENV] = str(Path(port_src).resolve())
        sys.path.insert(0, os.environ[PORT_SRC_ENV])
    import repro_torch

    t0 = time.perf_counter()
    port = str(Path(repro_torch.__file__).resolve().parent)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_tp_")
    try:
        spawn_s = spawn_ranks(mesh_tp_rank, (free_port(), tmp, seed, not port_src), 4)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(4)]
        four = [r["tp_train"] for r in ranks]
        if port_src:
            emit({"phase": "mesh", "step": "mesh_tp_4_train_peak", "card": nvidia_smi(),
                  "port": port, "peak_mem_bytes": [r["peak_mem_bytes"] for r in four],
                  "losses": four[0]["losses"], "one_rank_losses": four[0]["one_rank_losses"],
                  "step_s": [r["step_s"] for r in four], "spawn_s": spawn_s})
            return 0
        serve = [mesh_tp_serve_check(seed, spec, [r["tp_serve"][i] for r in ranks], tmp)
                 for i, spec in enumerate(MESH_TP_SERVE)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mesh_tp_line(four, [[r["tp_serve"][i] for r in ranks] for i in range(len(serve))], serve)
    emit({"phase": "mesh", "step": "done", "port": port, "spawn_s": spawn_s,
          "seconds": time.perf_counter() - t0})
    return 0


def mesh_db_np(seed) -> dict:
    """Part (a)'s A3 relations, drawn on the host."""
    from repro_torch.core import queries

    rows = 2 ** MESH["msj_log2_rows"]
    return queries.gen_db(a3_semijoins()[0], n_guard=rows, n_cond=rows, sel=0.5, seed=seed)


def msj_reference(db_np, tmp):
    """Part (a)'s reference: the A3 job on ``db_np`` (from
    :func:`mesh_db_np`) under ``SimComm(P)`` on the card, its count-sized
    ``forward_cap`` fixed here; each shard's result and the relations
    written to ``tmp`` for the ranks."""
    import numpy as np
    import torch

    from repro_torch.core import msj
    from repro_torch.core.relation import db_from_dict
    from repro_torch.engine.comm import SimComm, run_pipeline

    P = MESH["msj_P"]
    _, sjs = a3_semijoins()
    db = db_from_dict(db_np, P=P, device=DEVICE)
    cap = msj.count_forward_cap(msj.make_spec(sjs), db, SimComm(P))
    kit, stages = msj_stages(db, sjs, SimComm(P), cap)
    run_pipeline(SimComm(P), stages, kit.stacked)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = result_tensors(run_pipeline(SimComm(P), stages, kit.stacked))
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    for r in range(P):
        torch.save([t[r].cpu() for t in want], Path(tmp) / f"want{r}.pt")
    for k, a in db_np.items():
        np.save(Path(tmp) / f"db_{k}.npy", a)
    return db_np, sjs, cap, sim_wall


def mesh_msj_nccl(db_np, sjs, mesh) -> dict:
    """Part (a) at P = 1 over NCCL: the stages under ``MeshComm`` against
    ``SimComm(1)``, the launch counters from 0 around the measured run."""
    import torch

    from repro_torch.core import msj
    from repro_torch.core.relation import db_from_dict
    from repro_torch.engine.comm import MeshComm, SimComm, run_pipeline

    db = db_from_dict(db_np, P=1, device=DEVICE)
    cap = msj.count_forward_cap(msj.make_spec(sjs), db, SimComm(1))
    kit, stages = msj_stages(db, sjs, SimComm(1), cap)
    want = [t[0] for t in result_tensors(run_pipeline(SimComm(1), stages, kit.stacked))]
    comm = MeshComm(mesh, "data")
    kit, stages = msj_stages(db, sjs, comm, cap)
    run_pipeline(comm, stages, kit.stacked)  # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = result_tensors(run_pipeline(comm, stages, kit.stacked))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    path_launches("mesh_msj nccl", launches)
    return {"P": 1, "forward_cap": cap, "wall_s": wall, "launches": launches,
            "bit_identical": all(torch.equal(a, b) for a, b in zip(want, got))}


def state_leaves(state) -> dict:
    """Every tensor of a train state by name (DTensors as they are)."""
    out = {"opt.step": state["opt"]["step"]}
    for key, m in (("params", state["params"]), ("opt.mu", state["opt"]["mu"]),
                   ("opt.nu", state["opt"]["nu"])):
        out.update({f"{key}.{n}": p for n, p in m.named_parameters()})
    return out


def rel_l2(want, got) -> float:
    import torch

    want, got = want.detach().double(), got.detach().double()
    return float(torch.linalg.vector_norm(want - got) / torch.linalg.vector_norm(want))


def same_state(a, b) -> bool:
    """Two states hold the same shards, bit for bit, in the same placements."""
    import torch

    from repro_torch.launch.mesh import local

    la, lb = state_leaves(a), state_leaves(b)
    return la.keys() == lb.keys() and all(
        getattr(la[k], "placements", None) == getattr(lb[k], "placements", None)
        and torch.equal(local(la[k]), local(lb[k])) for k in la)


def mesh_train(seed, mesh):
    """Part (b): qwen3-0.6b whole on the (1, 1) NCCL mesh against no mesh,
    the same steps from the same seed under deterministic algorithms
    (the card's embedding backward otherwise sums with atomics); then a
    checkpoint saved with ``mesh=`` and loaded with ``specs=``, and
    ``reshard_state`` onto a fresh (1, 1) mesh, each bit-identical."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.ft import elastic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import optimizer, train_step as ts

    cfg = get_config(TRAIN["arch"])
    steps = MESH["train_steps"]
    opt_cfg = optimizer.OptConfig(lr=3e-4, warmup_steps=1, total_steps=steps)
    step_fn = ts.make_train_step(cfg, opt_cfg, microbatches=cfg.train_microbatches)
    batches = [synthetic.token_batch(cfg, "train", TRAIN["batch"], TRAIN["seq"], i, seed=seed,
                                     device=DEVICE) for i in range(steps)]
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label in ("plain", "sharded"):
            # the plain state stays allocated through the sharded run (for
            # the comparison): each run's peak is also given above its start
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            state = ts.init_state(cfg, seed, opt_cfg, device=DEVICE)
            if label == "sharded":
                state = elastic.reshard_state(state, ts.state_specs(cfg, state, mesh), mesh)
            losses, walls = [], []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))  # synchronizes
                walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            runs[label] = {"state": state, "losses": losses, "step_s": walls,
                           "peak_mem_bytes": peak, "allocated_at_start_bytes": start,
                           "peak_above_start_bytes": peak - start}
    finally:
        torch.use_deterministic_algorithms(False)
    plain, sharded = runs["plain"]["state"], runs["sharded"]["state"]
    lp, ls = state_leaves(plain), state_leaves(sharded)
    differ = {k: rel_l2(lp[k].float(), mesh_lib.local(ls[k]).float()) for k in lp
              if not torch.equal(lp[k], mesh_lib.local(ls[k]))}
    bit_identical = not differ and runs["plain"]["losses"] == runs["sharded"]["losses"]
    del plain, lp, ls, runs["plain"]["state"]
    torch.cuda.empty_cache()

    specs = ts.state_specs(cfg, sharded, mesh)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    try:
        t0 = time.perf_counter()
        checkpoint.save(tmp, steps, sharded, mesh=mesh)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = checkpoint.load(tmp, steps, sharded, mesh=mesh, specs=specs)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    load_equal = same_state(sharded, loaded)
    del loaded
    fresh = init_device_mesh(mesh.device_type, (1, 1), mesh_dim_names=mesh_lib.AXES)
    t0 = time.perf_counter()
    moved = elastic.reshard_state(sharded, ts.state_specs(cfg, sharded, fresh), fresh)
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    reshard_equal = same_state(sharded, moved)
    del moved, sharded, runs["sharded"]["state"]
    line = {"phase": "mesh", "step": "mesh_train", "card": nvidia_smi(), "arch": cfg.name,
            "mesh": mesh_lib.axis_sizes(mesh), "backend": dist.get_backend(),
            "batch": TRAIN["batch"],
            "seq": TRAIN["seq"], "microbatches": cfg.train_microbatches,
            "deterministic_algorithms": True,
            "plain": runs["plain"], "sharded": runs["sharded"], "bit_identical": bit_identical,
            "leaves_not_bit_identical": differ, "tol_if_not": SHARDED_TOL,
            "checkpoint_save_s": save_s, "checkpoint_load_s": load_s,
            "checkpoint_bit_identical": load_equal, "reshard_s": reshard_s,
            "reshard_bit_identical": reshard_equal}
    emit(line)
    close = runs["plain"]["losses"] == runs["sharded"]["losses"] or all(
        abs(a - b) <= SHARDED_TOL * abs(a)
        for a, b in zip(runs["plain"]["losses"], runs["sharded"]["losses"]))
    if not (close and all(v <= SHARDED_TOL for v in differ.values()) and load_equal
            and reshard_equal):
        raise AssertionError(f"mesh_train failed: {line}")
    return line


def twin_compare(cfg, seed, opt_cfg, batches, lr, full, keys) -> dict:
    """The one-rank steps again with their gradient summed in two
    microbatches (the same function, the sum regrouped as the mesh's two
    data shards group it), on this rank: the parameter elements whose
    values this regrouping alone moves by more than the leaf's share of
    ``MESH_TOL`` (|Δ| > MESH_TOL · |p|₂ / √n) are those one rank does not
    itself repeat to ``MESH_TOL``: AdamW divides each gradient element by
    its own magnitude plus eps, so at an element whose gradient is near
    eps it magnifies the sum's rounding, or where a step's gradient nearly
    cancels the first moment.  Returns the sharded parameters' |Δ|₂/|p|₂
    per leaf against the one-rank run over every other element, how many
    were left out of each leaf, and the sharded parameters against the
    twin over every element."""
    import torch

    from repro_torch.train import train_step as ts

    twin = ts.init_state(cfg, seed, opt_cfg, device=DEVICE)
    step = ts.make_train_step(cfg, opt_cfg, microbatches=2)
    for batch in batches:
        twin, _ = step(twin, batch)
    tw = {f"params.{n}": p.detach() for n, p in twin["params"].named_parameters()}
    del twin
    out, left = {}, {}
    for k in keys:
        keep = (lr[k] - tw[k]).abs() <= MESH_TOL * torch.linalg.vector_norm(lr[k]) \
            / math.sqrt(lr[k].numel())
        left[k] = int((~keep).sum())
        out[k] = rel_l2(lr[k][keep], full[k][keep])
    return {"param_rel_l2_repeatable": out, "twin_param_rel_l2_max": max(
        rel_l2(lr[k], tw[k]) for k in keys),
        "mesh_twin_param_rel_l2": {k: rel_l2(tw[k], full[k]) for k in keys},
        "not_repeatable_by_leaf": {k: [n, lr[k].numel()] for k, n in left.items() if n},
        "elements_not_repeatable": sum(left.values()),
        "elements": sum(lr[k].numel() for k in keys)}


def first_moments(state, keep: bool) -> dict | None:
    """AdamW's first moments of ``state`` after its first step, each leaf
    gathered (a collective over the mesh), on the host where ``keep``: the
    first step's clipped gradients times ``1 - b1``, taken at the initial
    parameters, so the sharded and the one-rank runs differ there only in
    the order of their sums (the parameters after AdamW do not: see
    :func:`twin_compare`)."""
    from repro_torch.launch.mesh import full_value

    out = {}
    for k, v in state_leaves(state).items():
        if k.startswith("opt.mu."):
            full = full_value(v)
            if keep:  # a copy: a replicated leaf's full value is its live shard
                out["params." + k[len("opt.mu."):]] = full.to("cpu", copy=True)
            del full
    return out if keep else None


def local_state_bytes(state) -> int:
    from repro_torch.launch.mesh import local

    return sum(local(x).numel() * x.element_size() for x in state_leaves(state).values())


def spec_state_bytes(cfg, state, mesh) -> int:
    """One rank's bytes of ``state`` as ``state_specs`` places them."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models import model
    from repro_torch.train import train_step as ts

    sizes = axis_sizes(mesh)
    specs = model.param_specs(state["params"], ts.state_specs(cfg, state, mesh)["params"])
    total = state["opt"]["step"].element_size()
    for name, p in state["params"].named_parameters():
        n = p.numel()
        for entry in specs[name]:
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                n //= sizes[a]
        total += 3 * n * 4  # parameter, mu, nu: float32
    return total


def mesh_train4_rank(rank, tmp, seed, spec, checkpoints: bool) -> dict:
    """Parts (c) and (d)'s training, one rank of four on (2, 2), under
    deterministic algorithms (so the run repeats): ``spec``'s steps of
    ``spec["arch"]`` at its width, ``spec["layers"]`` layers, float32, one
    microbatch; rank 0 then runs the same steps with no mesh and, with
    ``checkpoints``, loads the (2, 2) checkpoint onto (1, 1), else runs
    :func:`twin_compare`."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.ft import elastic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import parallel
    from repro_torch.train import optimizer, train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = get_config(spec["arch"], n_layers=spec["layers"], dtype="float32")
    steps = spec["steps"]
    opt_cfg = optimizer.OptConfig(lr=3e-4, warmup_steps=1, total_steps=steps)
    kind = torch.device(DEVICE).type
    m22 = init_device_mesh(kind, (2, 2), mesh_dim_names=mesh_lib.AXES)
    m11 = DeviceMesh(kind, [[0]], mesh_dim_names=mesh_lib.AXES)
    step_fn = ts.make_train_step(cfg, opt_cfg)
    batches = [synthetic.token_batch(cfg, "train", spec["batch"], spec["seq"], i,
                                     seed=seed, device=DEVICE) for i in range(steps)]
    state = ts.init_state(cfg, seed, opt_cfg, device=DEVICE)
    state = elastic.reshard_state(state, ts.state_specs(cfg, state, m22), m22)
    gc.collect()
    torch.cuda.empty_cache()
    state_bytes = local_state_bytes(state)
    spec_bytes = spec_state_bytes(cfg, state, m22)
    allocated = torch.cuda.memory_allocated()
    parallel.reset_stats()
    losses, norms, walls, peaks, mu1 = [], [], [], [], None
    for i, batch in enumerate(batches):
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        peaks.append(torch.cuda.max_memory_allocated())
        if i == 0 and not checkpoints:
            mu1 = first_moments(state, keep=rank == 0)
    peak = max(peaks)
    gathered = parallel.STATS["params_peak"]
    layer_bytes = max(sum(p.numel() * p.element_size() for p in lp.parameters())
                      for lp in state["params"].layers)
    ends_bytes = max(w.numel() * w.element_size() for w in (state["params"].embed,
                                                             state["params"].lm_head))
    # every leaf for the checkpoint's check, else the parameters (a collective)
    full = {k: mesh_lib.full_value(v) for k, v in state_leaves(state).items()
            if checkpoints or k.startswith("params.")}
    out = {"rank": rank, "coordinate": m22.get_coordinate(), "losses": losses,
           "grad_norms": norms, "step_s": walls,
           "state_bytes": state_bytes, "spec_bytes": spec_bytes,
           "allocated_after_sharding": allocated, "peak_mem_bytes": peak,
           "gathered_peak_bytes": gathered,
           "one_layer_plus_ends_bytes": layer_bytes + ends_bytes}
    if checkpoints:
        ckpt = str(Path(tmp) / "ckpt")
        t0 = time.perf_counter()
        checkpoint.save(ckpt, steps, state, mesh=m22)
        out["save_s"] = time.perf_counter() - t0
    # the other ranks free the card and wait while rank 0 runs one rank's steps
    if rank != 0 or not checkpoints:
        del state
    if rank != 0:
        del full
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        ref = ts.init_state(cfg, seed, opt_cfg, device=DEVICE)
        init = {f"params.{n}": p.detach().clone() for n, p in ref["params"].named_parameters()}
        ref_losses, ref_norms = [], []
        for i, batch in enumerate(batches):
            ref, m = step_fn(ref, batch)
            ref_losses.append(float(m["loss"]))
            ref_norms.append(float(m["grad_norm"]))
            if i == 0 and mu1 is not None:
                # the first step's gradients over every element of every leaf
                out["grad1_rel_l2"] = {
                    f"params.{n}": rel_l2(p, mu1.pop(f"params.{n}").to(DEVICE))
                    for n, p in ref["opt"]["mu"].named_parameters()}
        lr = {k: v.detach() for k, v in state_leaves(ref).items()}
        keys = [k for k in lr if k.startswith("params.")]
        del ref
        out["one_rank_losses"] = ref_losses
        out["one_rank_grad_norms"] = ref_norms
        out["param_rel_l2"] = {k: rel_l2(lr[k], full[k]) for k in keys}
        out["param_max_abs_diff"] = max(float((lr[k] - full[k]).abs().max()) for k in keys)
        # the control: parameters left at their initial values, which the
        # parameter check must refuse
        control = [rel_l2(lr[k], init[k]) for k in keys]
        out["control_param_rel_l2"] = {"max": max(control), "min": min(control)}
        if not checkpoints:
            out.update(twin_compare(cfg, seed, opt_cfg, batches, lr, full, keys))
        del lr, init
    if rank == 0 and checkpoints:
        t0 = time.perf_counter()
        loaded = checkpoint.load(ckpt, steps, state, mesh=m11,
                                 specs=ts.state_specs(cfg, state, m11))
        out["load_11_s"] = time.perf_counter() - t0
        ll = state_leaves(loaded)
        out["load_11_bit_identical"] = ll.keys() == full.keys() and all(
            torch.equal(mesh_lib.local(ll[k]), full[k]) for k in full)
        del loaded, ll, state
    if rank == 0:
        del full
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    torch.use_deterministic_algorithms(False)
    return out


def serve_inputs(cfg, spec, seed, device):
    """``spec``'s prompt batch (tokens; and stub frames for the enc-dec
    family) and its decode tokens, drawn from ``seed``."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed + 7)
    B = spec["batch"]
    tokens = torch.randint(0, cfg.vocab, (B, spec["prompt"] + spec["decode"]), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens[:, :spec["prompt"]].to(device)}
    if "frames" in spec:
        batch["embeds"] = (0.1 * torch.randn((B, spec["frames"], cfg.d_model),
                                             generator=gen)).to(device)
    return batch, tokens[:, spec["prompt"]:].to(device)


def serve_steps(cfg, params, batch, toks, max_len):
    """Prefill, then a decode step per column of ``toks``: (the cache, the
    logits of each step stacked (steps + 1, rows, V), the walls)."""
    import torch

    from repro_torch.models import model

    walls, logits = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, lg = model.prefill(cfg, params, batch, max_len)
    for j in range(toks.shape[1] + 1):
        logits.append(getattr(lg, "to_local", lambda: lg)())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if j == toks.shape[1]:
            break
        t0 = time.perf_counter()
        cache, lg = model.decode_step(cfg, params, cache, toks[:, j:j + 1])
    return cache, torch.stack(logits), walls


def mesh_tp_serve_rank(rank, tmp, seed, spec) -> dict:
    """Part (d)'s serving, one rank of four on (2, 2): ``spec``'s model at
    its width in float32 (TF32 off), placed by ``partition_specs``; a
    sharded prefill and decode steps on the rank's rows, its logits
    written to ``tmp`` for the one-rank run; the cache's placements against
    ``cache_specs``' and the cache leaves gathered over ``model``."""
    import torch
    from types import SimpleNamespace

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.ft import elastic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model, parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(spec["arch"], dtype="float32", **spec["overrides"])
    m22 = init_device_mesh(torch.device(DEVICE).type, (2, 2), mesh_dim_names=mesh_lib.AXES)
    params = model.init_params(cfg, seed, device=DEVICE)
    params = elastic.reshard_state({"params": params}, {"params": model.partition_specs(
        cfg, params, m22)}, m22)["params"]
    batch, toks = serve_inputs(cfg, spec, seed, DEVICE)
    batch = elastic.reshard_state(batch, model.batch_specs(cfg, batch, m22), m22)
    toks = elastic.reshard_state({"t": toks}, {"t": model.batch_specs(cfg, {"t": toks}, m22)[
        "t"]}, m22)["t"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    parallel.reset_stats()
    with torch.no_grad():
        cache, logits, walls = serve_steps(cfg, params, batch, toks,
                                           spec["prompt"] + spec["decode"])
    peak = torch.cuda.max_memory_allocated()
    gathers = dict(parallel.CACHE_GATHERS)
    specs = model.cache_specs(cfg, {k: SimpleNamespace(shape=v.shape)
                                    for k, v in cache.items()}, m22)
    placed = all(tuple(v.placements) == tuple(model.placements(specs[k], m22))
                 for k, v in cache.items())
    torch.save(logits.cpu(), Path(tmp) / f"tp_{cfg.name}_{rank}.pt")
    del params, cache, logits
    return {"rank": rank, "arch": spec["arch"], "coordinate": m22.get_coordinate(),
            "prefill_s": walls[0], "decode_s": walls[1:], "peak_mem_bytes": peak,
            "gathered_peak_bytes": {k: parallel.STATS[f"{k}_peak"] for k in ("params", "cache")},
            "cache_gathers": gathers, "cache_in_cache_specs": placed}


def mesh_tp_serve_check(seed, spec, ranks, tmp) -> dict:
    """Part (d)'s serving, the one-rank runs in this process: the same
    model, prompts and decode tokens with no mesh, all rows at once, in
    float64 (the float32 weights cast; the reference each rank's float32
    logits are held to on its rows), in float32 (the one-rank run's own
    distance to it, the floor) and in bfloat16 (the control, which the
    check must refuse)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model

    def rel(want, got):  # per step: max |Δ| / max |want|
        return [float((g - w).abs().max() / w.abs().max()) for w, g in zip(want, got)]

    def rel2(want, got):  # per step: |Δ|₂ / |want|₂
        return [rel_l2(w, g) for w, g in zip(want, got)]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = spec["batch"] // 2
    try:
        params = model.init_params(get_config(spec["arch"], dtype="float32", **spec["overrides"]),
                                   seed, device=DEVICE)
        batch, toks = serve_inputs(get_config(spec["arch"], **spec["overrides"]), spec, seed,
                                   DEVICE)
        runs, walls = {}, {}
        with torch.no_grad():
            for name in ("float32", "float64", "bfloat16"):  # the weights cast in place
                dt = getattr(torch, name)
                cfg = get_config(spec["arch"], dtype=name, **spec["overrides"])
                params.to(dt)
                b = {k: v.to(dt) if v.is_floating_point() else v for k, v in batch.items()}
                _, runs[name], walls[name] = serve_steps(cfg, params, b, toks,
                                                         spec["prompt"] + spec["decode"])
        del params
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = runs["float64"]
    steps, steps_max = [], []
    for r in ranks:
        got = torch.load(Path(tmp) / f"tp_{cfg.name}_{r['rank']}.pt").to(DEVICE)
        own = want[:, r["coordinate"][0] * rows:(r["coordinate"][0] + 1) * rows]
        steps.append(rel2(own, got))
        steps_max.append(rel(own, got))
    torch.cuda.empty_cache()
    return {"arch": spec["arch"], "config": {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "vocab")}, "reference": "float64",
        "one_rank_prefill_s": walls["float32"][0], "one_rank_decode_s": walls["float32"][1:],
        "logit_rel_l2": [max(e) for e in steps], "logit_rel_l2_by_step": steps,
        "logit_max_rel_err": [max(e) for e in steps_max],
        "one_rank_f32_rel_l2": max(rel2(want, runs["float32"])),
        "one_rank_f32_max_rel_err": max(rel(want, runs["float32"])),
        "control_bf16_rel_l2": max(rel2(want, runs["bfloat16"]))}


def phase_mesh(seed: int, db_np) -> list:
    """The multi-card layer (``db_np``: a future of :func:`mesh_db_np`).
    The parent writes part (a)'s ``SimComm``
    reference, runs part (a) at P = 1 and part (b) over its one-rank NCCL
    group and tears the group down; then one spawn of four gloo ranks runs
    parts (a), (c) and (d), and the parent runs part (d)'s one-rank
    serving.  Lines: ``mesh_train``, ``mesh_msj``, ``mesh_train_4``,
    ``mesh_tp_4``, ``done``; returns ``mesh_msj`` first (its launches count
    on the kernels line)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rows, P = 2 ** MESH["msj_log2_rows"], MESH["msj_P"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        db_np, sjs, cap, sim_wall = msj_reference(db_np.result(), tmp)
        torch.cuda.empty_cache()
        mesh = make_host_mesh(DEVICE)
        nccl = mesh_msj_nccl(db_np, sjs, mesh)
        del db_np
        torch.cuda.empty_cache()
        train_line = mesh_train(seed, mesh)
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        spawn_s = spawn_ranks(mesh_rank, (free_port(), tmp, cap, P, seed), P)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(P)]
        serve = [mesh_tp_serve_check(seed, spec, [r["tp_serve"][i] for r in ranks], tmp)
                 for i, spec in enumerate(MESH_TP_SERVE)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    msj_ranks = [r["msj"] for r in ranks]
    for r in msj_ranks:
        path_launches(f"mesh_msj rank {r['rank']}", r["launches"])
    launches = {k: sum(r["launches"][k] for r in msj_ranks) + nccl["launches"][k]
                for k in nccl["launches"]}
    msj_line = {"phase": "mesh", "step": "mesh_msj", "card": nvidia_smi(),
                "rows_per_relation": rows, "P": P, "backend": "gloo", "forward_cap": cap,
                "probe_wrapper": "probe_bucketed", "launches": launches, "ranks": msj_ranks,
                "rank0_wall_s": msj_ranks[0]["wall_s"],
                "rank0_peak_mem_bytes": msj_ranks[0]["peak_mem_bytes"],
                "simcomm_wall_s": sim_wall, "spawn_s": spawn_s, "nccl": nccl}
    emit(msj_line)
    if not (all(r["bit_identical"] for r in msj_ranks) and nccl["bit_identical"]):
        raise AssertionError(f"mesh_msj: MeshComm differs from SimComm: {msj_line}")

    four = [r["train_4"] for r in ranks]
    r0 = four[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["one_rank_losses"]))
    norm_err = max(abs(a - b) / abs(b)
                   for a, b in zip(r0["grad_norms"], r0["one_rank_grad_norms"]))
    four_line = {"phase": "mesh", "step": "mesh_train_4", "card": nvidia_smi(),
                 "arch": TRAIN["arch"], "layers": MESH["four_layers"], "dtype": "float32",
                 "tf32": False, "deterministic_algorithms": True,
                 "mesh": {"data": 2, "model": 2}, "backend": "gloo",
                 "batch": MESH["four_batch"], "seq": MESH["four_seq"], "ranks": four,
                 "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
                 "param_rel_l2_max": max(r0["param_rel_l2"].values()),
                 "control_param_rel_l2": r0["control_param_rel_l2"], "tol": MESH_TOL,
                 "tensor_parallel": True,
                 "peak_mem_bytes": [r["peak_mem_bytes"] for r in four],
                 "whole_gather_peak_bytes": MESH_TRAIN_4_WHOLE_GATHER_PEAK,
                 "gathered_peak_bytes": [r["gathered_peak_bytes"] for r in four],
                 "one_layer_plus_ends_bytes": r0["one_layer_plus_ends_bytes"]}
    emit(four_line)
    if not (all(r["state_bytes"] == r["spec_bytes"] for r in four)
            and all(r["peak_mem_bytes"] < MESH_TRAIN_4_WHOLE_GATHER_PEAK for r in four)
            and all(0 < r["gathered_peak_bytes"] <= r["one_layer_plus_ends_bytes"]
                    for r in four)
            and all(r["losses"] == r0["losses"] for r in four)
            and all(r["grad_norms"] == r0["grad_norms"] for r in four)
            and loss_err <= MESH_TOL and norm_err <= MESH_TOL
            and four_line["param_rel_l2_max"] <= MESH_TOL
            and r0["control_param_rel_l2"]["max"] > MESH_TOL
            and r0["load_11_bit_identical"]):
        raise AssertionError(f"mesh_train_4 failed: {four_line}")
    tp_line = mesh_tp_line([r["tp_train"] for r in ranks],
                           [[r["tp_serve"][i] for r in ranks] for i in range(len(serve))],
                           serve)
    done = {"phase": "mesh", "step": "done", "seconds": time.perf_counter() - t_phase}
    emit(done)
    return [msj_line, train_line, four_line, tp_line, done]


def mesh_tp_line(four, serve_ranks, serve) -> dict:
    """Part (d)'s line and its checks, laid out as ``mesh_train_4``'s:
    training within ``MESH_TOL`` of one rank (the control above it; the
    parameters over the elements one rank repeats, at most one in 10⁴ left
    out, each leaf's count printed; the first step's gradients over every
    element of every leaf), each rank's peak below the layer-gathering
    tree's; serving within ``MESH_TOL`` of the
    float64 one-rank run on each rank's rows (|Δ|₂/|w|₂ per step, as the
    parameters; the float32 one-rank run's own distance printed beside),
    the bfloat16 control above it, the cache in ``cache_specs``'
    placements, no SSM state gathered over ``model``."""
    r0 = four[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["one_rank_losses"]))
    norm_err = max(abs(a - b) / abs(b)
                   for a, b in zip(r0["grad_norms"], r0["one_rank_grad_norms"]))
    for entry, ranks in zip(serve, serve_ranks):
        entry.update({k: [r[k] for r in ranks] for k in (
            "prefill_s", "decode_s", "peak_mem_bytes", "gathered_peak_bytes", "cache_gathers",
            "cache_in_cache_specs")})
    line = {"phase": "mesh", "step": "mesh_tp_4", "card": nvidia_smi(),
            "mesh": {"data": 2, "model": 2}, "backend": "gloo", "dtype": "float32",
            "tf32": False, "tensor_parallel": True,
            "train": {**MESH_TP_TRAIN, "deterministic_algorithms": True, "ranks": four,
                      "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
                      "param_rel_l2_max": max(r0["param_rel_l2"].values()),
                      "param_rel_l2_repeatable_max": max(
                          r0["param_rel_l2_repeatable"].values()),
                      "twin_param_rel_l2_max": r0["twin_param_rel_l2_max"],
                      "mesh_twin_param_rel_l2_max": max(
                          r0["mesh_twin_param_rel_l2"].values()),
                      "elements_not_repeatable": r0["elements_not_repeatable"],
                      "not_repeatable_by_leaf": r0["not_repeatable_by_leaf"],
                      "elements": r0["elements"],
                      "grad1_rel_l2_max": max(r0["grad1_rel_l2"].values()),
                      "grad1_rel_l2": r0["grad1_rel_l2"],
                      "control_param_rel_l2": r0["control_param_rel_l2"], "tol": MESH_TOL,
                      "peak_mem_bytes": [r["peak_mem_bytes"] for r in four],
                      "layer_gather_peak_bytes": MESH_TP_TRAIN_LAYER_GATHER_PEAK,
                      "gathered_peak_bytes": [r["gathered_peak_bytes"] for r in four],
                      "one_layer_plus_ends_bytes": r0["one_layer_plus_ends_bytes"]},
            "serve": serve, "tol": MESH_TOL}
    emit(line)
    if not (all(r["state_bytes"] == r["spec_bytes"] for r in four)
            and all(r["peak_mem_bytes"] < MESH_TP_TRAIN_LAYER_GATHER_PEAK for r in four)
            and all(0 < r["gathered_peak_bytes"] <= r["one_layer_plus_ends_bytes"]
                    for r in four)
            and all(r["losses"] == r0["losses"] for r in four)
            and all(r["grad_norms"] == r0["grad_norms"] for r in four)
            and loss_err <= MESH_TOL and norm_err <= MESH_TOL
            and line["train"]["param_rel_l2_repeatable_max"] <= MESH_TOL
            and r0["elements_not_repeatable"] <= 1e-4 * r0["elements"]
            and max(r0["grad1_rel_l2"].values()) <= MESH_TOL
            and r0["control_param_rel_l2"]["max"] > MESH_TOL
            and all(e <= MESH_TOL for s in serve for e in s["logit_rel_l2"])
            and all(s["control_bf16_rel_l2"] > MESH_TOL for s in serve)
            and all(all(s["cache_in_cache_specs"]) for s in serve)
            and all(not any(k.startswith("ssm") for k in g) for s in serve
                    for g in s["cache_gathers"])):
        raise AssertionError(f"mesh_tp_4 failed: {line}")
    return line


# --------------------------------------------------------------------------
# phase 12: the dry-run's counts held to real steps
# --------------------------------------------------------------------------

#: the dryrun phase: (a) qwen3-0.6b's train step at the train phase's batch
#: and (b) its decode step against a full 32k cache, each traced on fake
#: tensors on a fake (1, 1) mesh in a spawned process and run for real on
#: the (1, 1) NCCL mesh; (c) the CLI on the production meshes
DRYRUN = {"arch": "qwen3-0.6b", "train_batch": 8, "train_seq": 4096,
          "decode_batch": 8, "decode_ctx": 32768, "cli_shape": "train_4k",
          "timeout_s": 400}
PEAK_TOL = 0.10  # |predicted - measured| / measured peak above the step's start


def dryrun_shape(kind: str):
    from repro_torch.configs import ShapeSpec

    if kind == "train":
        return ShapeSpec(f"train_{DRYRUN['train_batch']}x{DRYRUN['train_seq']}",
                         DRYRUN["train_seq"], DRYRUN["train_batch"], "train")
    return ShapeSpec(f"decode_{DRYRUN['decode_batch']}x{DRYRUN['decode_ctx']}",
                     DRYRUN["decode_ctx"], DRYRUN["decode_batch"], "decode")


def dryrun_child(kind: str, path: str, device: str) -> None:
    """A spawned process: rank 0 of a fake group of one on a fake (1, 1)
    mesh (the fake group must be the process's default group) traces the
    ``kind`` step of ``dryrun_shape`` on fake ``device`` tensors and writes
    its record to ``path``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun, mesh as mesh_lib

    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    mesh_lib.make_fake_group(1)
    mesh = init_device_mesh(device, (1, 1), mesh_dim_names=mesh_lib.AXES)
    rec = dryrun.run_cell(DRYRUN["arch"], dryrun_shape(kind), mesh=mesh, device=device,
                          verbose=False)
    Path(path).write_text(json.dumps(rec))


def wrap_11(tree: dict, specs: dict, mesh) -> dict:
    """Each tensor of ``tree`` as a DTensor on the (1, 1) mesh in its
    spec's placements, without a copy (every shard is the whole tensor)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import model

    return {k: DTensor.from_local(v, mesh, model.placements(specs[k], mesh), run_check=False)
            for k, v in tree.items()}


def real_step(fn) -> dict:
    """``fn()`` once under ``FlopCounterMode``, then once timed (host
    clock to a synchronize) with the peak memory above its start."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn()
    del out
    gc.collect()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    del out
    return {"flop_counter_flops": fc.get_total_flops(), "step_s": wall,
            "allocated_at_start_bytes": start, "peak_above_start_bytes": peak}


def dryrun_real(seed: int, mesh) -> dict:
    """Parts (a) and (b) for real on the (1, 1) mesh: the same state,
    batch and cache as the traces, placed by the same specs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic
    from repro_torch.ft import elastic
    from repro_torch.models import model
    from repro_torch.train import optimizer, train_step as ts

    cfg = get_config(DRYRUN["arch"])
    out = {}
    opt_cfg = optimizer.OptConfig()
    state = ts.init_state(cfg, seed, opt_cfg, device=DEVICE)
    state = elastic.reshard_state(state, ts.state_specs(cfg, state, mesh), mesh)
    batch = synthetic.token_batch(cfg, "train", DRYRUN["train_batch"], DRYRUN["train_seq"], 0,
                                  seed=seed, device=DEVICE)
    batch = elastic.reshard_state(batch, model.batch_specs(cfg, batch, mesh), mesh)
    step = ts.make_train_step(cfg, opt_cfg, microbatches=cfg.train_microbatches)
    holder = {"state": state}

    def train():
        holder["state"], m = step(holder["state"], batch)
        return float(m["loss"])

    out["train"] = real_step(train)
    del state, holder, batch
    gc.collect()
    torch.cuda.empty_cache()

    B, ctx = DRYRUN["decode_batch"], DRYRUN["decode_ctx"]
    params = model.init_params(cfg, seed, device=DEVICE)
    params = elastic.reshard_state({"params": params},
                                   {"params": model.partition_specs(cfg, params, mesh)},
                                   mesh)["params"]
    cache = model.init_cache(cfg, B, ctx, device=DEVICE)
    cache = wrap_11(cache, model.cache_specs(cfg, cache, mesh), mesh)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=DEVICE,
                           dtype=torch.int32)
    tokens = wrap_11({"tokens": tokens}, model.batch_specs(cfg, {"tokens": tokens}, mesh),
                     mesh)["tokens"]

    def decode():
        with torch.no_grad():
            return model.decode_step(cfg, params, cache, tokens)

    out["decode"] = real_step(decode)
    out["decode_cache_bytes"] = sum(v.to_local().numel() * v.element_size()
                                    for v in cache.values())
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def start_dryrun_traces() -> dict:
    """The ``dryrun`` phase's traces, each in a process of its own, all
    started together: two spawned traces on a fake (1, 1) mesh and the CLI
    on the production meshes.  They run on fake tensors and need no card
    time, so they are started before the ``train`` phase and run beside it
    and ``mesh``; :func:`phase_dryrun` collects them, :func:`stop_dryrun`
    ends what is left."""
    import multiprocessing
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    ctx = multiprocessing.get_context("spawn")
    kind_dev = torch.device(DEVICE).type
    started = {"tmp": tmp, "t0": time.perf_counter(), "cli": {}, "children": {
        k: ctx.Process(target=dryrun_child, args=(k, str(Path(tmp, f"{k}.json")), kind_dev))
        for k in ("train", "decode")}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for p in started["children"].values():
        p.start()
    for mp in (False, True):
        desc = "2x16x16" if mp else "16x16"
        started["cli"][desc] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN["arch"],
             "--shape", DRYRUN["cli_shape"], "--device", kind_dev,
             "--out", str(Path(tmp, f"cli_{desc}.json"))] + (["--multi-pod"] if mp else []),
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return started


def stop_dryrun(started: dict) -> None:
    """Ends every process of :func:`start_dryrun_traces` still running and
    removes their directory."""
    import shutil

    for p in started["children"].values():
        if p.is_alive():
            p.kill()
            p.join()
    for proc in started["cli"].values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    shutil.rmtree(started["tmp"], ignore_errors=True)


def phase_dryrun(seed: int, started: dict) -> list:
    """The dry-run (``repro_torch.launch.dryrun``) held to real steps on
    the card: the traced matmul FLOPs equal ``FlopCounterMode``'s, the
    predicted peak is within ``PEAK_TOL`` of the measured one, and the
    measured step takes at least the roofline's lower bound; then the
    CLI on the production meshes.  The traces (``started``, from
    :func:`start_dryrun_traces`) are collected after the real steps;
    ``trace_s`` is each trace's own clock, ``traces_wall_s`` the time
    from their start to their end here.  The caller ends them with
    :func:`stop_dryrun`."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    tmp, children, cli = started["tmp"], started["children"], started["cli"]
    mesh = make_host_mesh(DEVICE)
    real = dryrun_real(seed, mesh)
    dist.destroy_process_group()
    deadline = time.perf_counter() + DRYRUN["timeout_s"]
    for k, p in children.items():
        p.join(max(deadline - time.perf_counter(), 1))
        if p.exitcode != 0:
            raise AssertionError(f"dryrun: the {k} trace ended with {p.exitcode}")
    traced = {k: json.loads(Path(tmp, f"{k}.json").read_text()) for k in children}
    records = {}
    for desc, proc in cli.items():
        _, err = proc.communicate(timeout=max(deadline - time.perf_counter(), 1))
        if proc.returncode != 0:
            raise AssertionError(f"dryrun: the CLI on {desc} failed: {err[-2000:]}")
        records[desc] = json.loads(Path(tmp, f"cli_{desc}.json").read_text())[0]
    traces_wall = time.perf_counter() - started["t0"]

    lines, ok = [], True
    for kind in ("train", "decode"):
        rec, meas = traced[kind], real[kind]
        lb = rec["roofline"]["step_lower_bound_s"]
        peak_err = abs(rec["temp_bytes"] - meas["peak_above_start_bytes"]) \
            / meas["peak_above_start_bytes"]
        line = {"phase": "dryrun", "step": kind, "card": nvidia_smi(), "arch": DRYRUN["arch"],
                "shape": rec["shape"], "mesh": "1x1", "trace_s": rec["trace_s"],
                "n_ops": rec["n_ops"],
                "traced_matmul_flops": rec["xla_flops_per_chip"],
                "flop_counter_flops": meas["flop_counter_flops"],
                "flops_equal": int(rec["xla_flops_per_chip"]) == meas["flop_counter_flops"],
                "predicted_arg_bytes": rec["arg_bytes"],
                "allocated_at_start_bytes": meas["allocated_at_start_bytes"],
                "predicted_peak_above_start_bytes": rec["temp_bytes"],
                "measured_peak_above_start_bytes": meas["peak_above_start_bytes"],
                "peak_rel_err": peak_err, "peak_tol": PEAK_TOL,
                "step_s": meas["step_s"], "step_lower_bound_s": lb,
                "bottleneck": rec["roofline"]["bottleneck"],
                "t_compute": rec["roofline"]["t_compute"],
                "t_memory": rec["roofline"]["t_memory"],
                "measured_over_bound": meas["step_s"] / lb}
        if kind == "decode":
            line["cache_bytes"] = real["decode_cache_bytes"]
        emit(line)
        lines.append(line)
        ok &= line["flops_equal"] and peak_err <= PEAK_TOL and line["measured_over_bound"] >= 1
    for desc, rec in records.items():
        line = {"phase": "dryrun", "step": f"production_{desc}", "record": rec}
        emit(line)
        lines.append(line)
        ok &= rec["status"] == "ok" and rec["mesh"] == desc
    done = {"phase": "dryrun", "step": "done", "launches": read_counts(),
            "seconds": time.perf_counter() - t_phase, "traces_wall_s": traces_wall}
    emit(done)
    if any(done["launches"].values()):
        raise AssertionError("dryrun: a kernel of the MSJ path launched on the model path")
    if not ok:
        raise AssertionError(f"dryrun failed: {lines}")
    return lines + [done]


# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-rows", type=int, default=25)
    ap.add_argument("--compare-with", metavar="TREE",
                    help="another checkout of the port: time its bloom wrappers beside "
                         "this tree's on the same main-path inputs")
    ap.add_argument("--mesh-tp-only", nargs="?", const="", metavar="PORT_SRC",
                    help="only the mesh phase's part (d): four gloo ranks, then its checks; "
                         "with PORT_SRC (another checkout's src) only its training, on that "
                         "port, printing each rank's peak")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.mesh_tp_only is not None:
        return mesh_tp_only(args.seed, args.mesh_tp_only or None)

    from repro_torch.core import queries
    from repro_torch.core.algebra import semijoins_of
    from repro_torch.core.costmodel import HADOOP, stats_of_db
    from repro_torch.core.planner import plan_greedy, plan_one_round
    from repro_torch.core.relation import db_from_dict
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    P, rows = SHARDS, 2**args.log2_rows
    qs = queries.make_queries("A3")
    sjs = [sj for q in qs for sj in semijoins_of(q)]
    # the 1-ROUND and GREEDY databases are drawn on a host thread, in turn,
    # beside the build and the first phases
    g_rows = rows // 2
    draws = ThreadPoolExecutor(max_workers=1)
    db_np = draws.submit(queries.gen_db, qs, n_guard=rows, n_cond=rows, sel=0.5,
                         seed=args.seed)
    gdb_np = draws.submit(queries.gen_db, qs, n_guard=g_rows, n_cond=g_rows, sel=0.5,
                          seed=args.seed)
    draws.shutdown(wait=False)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    srcs = build.sources()
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:  # one nvcc each, all at once
        logs = dict(zip((s.name for s in srcs), pool.map(build.build, srcs)))
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "ptxas info" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [str(s.relative_to(ROOT)) for s in srcs], "ptxas": ptxas})

    t0 = time.perf_counter()
    db = db_from_dict(db_np.result(), P=P)
    del db_np
    torch.cuda.synchronize()
    emit({"phase": "data", "rows_per_relation": rows, "P": P,
          "relations": {k: list(r.data.shape) for k, r in db.items()},
          "seconds": time.perf_counter() - t0})

    main_case, in_bytes = capture_main_path_probe(db, sjs, P)
    timing = phase_kernel(main_case, in_bytes)
    phase_costmodel(main_case)
    del main_case

    e2e = [phase_e2e("one_round", db, plan_one_round(qs), P, rows)]
    del db
    torch.cuda.empty_cache()
    # GREEDY adds an EVAL job, whose forward buffer is the reference's
    # no-assumption bound (P x the sum of its inputs' capacities per shard
    # pair): at half the rows the buffer and its exchanged copy fit the card
    gdb = db_from_dict(gdb_np.result(), P=P)
    del gdb_np
    greedy_plan, greedy = plan_greedy(qs, stats_of_db(gdb), HADOOP), {}
    e2e.append(phase_e2e("greedy", gdb, greedy_plan, P, g_rows, keep=greedy))

    # the bloom prefilter on the same database, one bit per guard row
    bloom_bits = g_rows
    build_in, probe_in = capture_bloom_inputs(gdb, sjs, P, bloom_bits)
    timings = {"probe_bucketed": timing, **phase_bloom_kernels(build_in, probe_in, bloom_bits)}
    if args.compare_with:
        phase_bloom_compare(Path(args.compare_with).resolve(), build_in, probe_in, bloom_bits,
                            timings)
    del build_in, probe_in
    e2e.append(phase_e2e("one_round_bloom", gdb, plan_one_round(qs), P, g_rows,
                         bloom_bits=bloom_bits))
    torch.cuda.empty_cache()

    # the all-pairs probe is O(rows**2) per shard: its run is cut in rows
    b_rows = 2 ** min(BLOCKED_LOG2_ROWS, args.log2_rows)
    bdb = db_from_dict(queries.gen_db(qs, n_guard=b_rows, n_cond=b_rows, sel=0.5,
                                      seed=args.seed), P=P)
    timings["probe_blocked"], blocked = phase_blocked(bdb, sjs, P, b_rows)
    e2e.append(blocked)
    del bdb
    torch.cuda.empty_cache()

    # the executor's scheduling modes and fault tolerance on GREEDY's
    # database; the training corpus with its oracle and the mesh phase's
    # relations are drawn on host threads during its first parts
    corpus = in_background(train_corpus, args.seed, TRAIN)
    mesh_db = in_background(mesh_db_np, args.seed)
    e2e.append(phase_executor(gdb, greedy_plan, P, greedy, args.seed,
                              2 ** min(EXECUTOR_LOG2_ROWS, args.log2_rows - 3),
                              (corpus, mesh_db)))
    del gdb, greedy
    torch.cuda.empty_cache()

    # the service's fused tick has one EVAL job over 4 units x 5 inputs,
    # each unit's output P x its forward capacity rows per shard: at 2**21
    # rows the cold tick peaks near 66 GB (2**22 would need about 130 GB)
    service = phase_service(min(SERVICE_LOG2_ROWS, args.log2_rows - 3), P, args.seed)
    e2e.extend({**line, "probe_wrapper": "probe_bucketed"} for line in service)

    phase_oracle()
    # the examples' probe launches count on the kernels line
    e2e.extend(phase_examples())
    torch.cuda.empty_cache()
    for spec in LM_SERVE:
        phase_lm_serve(args.seed, spec)
        torch.cuda.empty_cache()
    traces = start_dryrun_traces()
    try:
        # the pipeline's probe launches count on the kernels line
        e2e.append(phase_train(args.seed, TRAIN, corpus)[0])
        torch.cuda.empty_cache()
        # and the mesh path's: every gloo rank's and the NCCL run's
        e2e.append(phase_mesh(args.seed, mesh_db)[0])
        torch.cuda.empty_cache()
        phase_dryrun(args.seed, traces)
    finally:
        stop_dryrun(traces)
    torch.cuda.empty_cache()

    sources = {
        "probe_bucketed": ("src/repro_torch/kernels/msj_probe/csrc/probe_hash.cu",
                           "src/repro/kernels/msj_probe/kernel.py:110"),
        "probe_blocked": ("src/repro_torch/kernels/msj_probe/csrc/probe_hash.cu",
                          "src/repro/kernels/msj_probe/kernel.py:148"),
        "bloom_build": ("src/repro_torch/kernels/bloom/csrc/bloom.cu",
                        "src/repro/kernels/bloom/kernel.py:85"),
        "bloom_pack": ("src/repro_torch/kernels/bloom/csrc/bloom.cu",
                       "src/repro/kernels/bloom/kernel.py:106"),
        "bloom_probe": ("src/repro_torch/kernels/bloom/csrc/bloom.cu",
                        "src/repro/kernels/bloom/kernel.py:106"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r["launches"][name] for r in e2e),
            **({"kernel_launches": {k: sum(r["launches"][k] for r in e2e
                                           if r.get("probe_wrapper") == name)
                                    for k in ("table_build", "table_probe")}}
               if name.startswith("probe_") else {}),
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            **({"wrapper_ms": t["wrapper_ms"]} if "wrapper_ms" in t else {}),
            "shape": {k: t[k] for k in ("np", "nb", "kw", "n", "sources", "bits") if k in t},
        })
    emit({"kernels": kernels, "seconds_total": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
