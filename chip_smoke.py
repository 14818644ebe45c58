#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one summary line each:

  0. the card's name and power limit (``nvidia-smi``), torch, CUDA and
     Python versions;
  1. build ``src/repro_torch/kernels/csrc/ring_q.cu`` (int8),
     ``ring_f32.cu`` (fp32) and ``ring_decode.cu`` (the decode attention
     over a ring KV cache) with nvcc for sm_90a, one nvcc each, all
     started together (time and the ``-Xptxas -v`` lines);
  2. every hand-written kernel against its plain PyTorch version on the
     card, with TF32 off: the eight int8 kernels bitwise, on every op of
     the nine committed int8 plans (DS-CNN, ResNet-8, MCUNet-5fps-VWW,
     ToyADMOS, the sliced MCUNet-320KB-ImageNet, MobileNetV1-0.25, the
     unsliced MCUNet-320KB-ImageNet for the cortex-m7, the DS-CNN stream
     and the GRU chain) and on the int8 edge
     cases of ``repro_torch.kernels.cases`` (``CARD_EDGE_CASES``' 8,385-row
     shifted add among them); the eleven fp32 kernels
     within the tolerance of ``cases.compare_f32`` (channel tails and
     unwritten lanes exact), on every op of the nine fp32 ``host-sim``
     plans (DS-CNN, ResNet-8, MCUNet-5fps-VWW, ToyADMOS, MobileNetV1-0.25,
     MCUNet-320KB-ImageNet, the DS-CNN stream, the GRU chain, the
     whisper-tiny MLP tower) and on the fp32
     edge cases (a gemma3-1b-width geglu layer and a d_model-4096 one
     among them; the depthwise and k x k convs also in place, where only
     a kernel that reads all of an op before storing matches, and the
     pointwise conv and the FC in place with a short last tile); which
     ops read their weights from global memory (too large for shared,
     used once, or streamed in chunks); for each ``ring_gemm`` /
     ``ring_conv_pw`` / ``ring_conv_dw`` / ``ring_conv_k2d`` /
     ``ring_conv_stream`` / ``ring_add`` / ``ring_inverted_bottleneck``
     / ``ring_conv_pw_q`` / ``ring_conv_dw_q`` / ``ring_conv_k2d_q`` /
     ``ring_conv_stream_q`` call, its CTAs and the bytes each holds across the grid barrier
     (``segment_matmul.gemm_tiling``, ``conv2d.conv_tiling``,
     ``conv2d.add_tiling``, ``inverted_bottleneck.ib_tiling``), for each
     ``ring_add_q`` call its mode (the barrier-free row map where
     ``quantized.add_needs_barrier`` is False, and the wrapper must have
     taken it; else read first), CTAs and bytes held, for each
     ``ring_gemm_q`` call its mode (one CTA in an ordinary launch, or
     column tiles under a grid barrier, as ``quantized.gemm_q_tiling``
     rules, and the wrapper must have taken it), CTAs and bytes held,
     for each ``ring_gru_cell_q`` and ``ring_gru_cell`` call its mode
     (one CTA, or channel tiles under a grid barrier, as
     ``stream.gru_q_tiling`` / ``stream.gru_tiling`` rules, and the
     wrapper must have taken it), CTAs and shared memory, for each
     ``ring_avgpool_q`` and ``ring_avgpool`` call its one CTA's threads,
     parts and chunk (``quantized.pool_q_tiling``,
     ``conv2d.pool_tiling``), for each
     ``ring_elementwise`` call its runs and blocks
     (``elementwise.ring_runs``, ``ew_blocks``); and for each
     ``ring_fused_mlp``
     call, the CTAs, row blocks and d_ff sub-tiles of its first kernel and
     its scratch bytes (``fused_mlp.mlp_tiling``);
     the sliced plan's 31 window reads, each with its base, CTAs and mode;
     then ``ring_decode_attention`` against its plain version on every
     case of ``cases.DECODE_CASES`` and ``cases.LM_DECODE_CASES`` (the
     other LMs' geometries: 10 q heads on one KV head of 256 over a
     wrapped 2,048-slot ring, 2 q heads per KV head of 64, a 1,500-slot
     cross memory with a ragged last block; fp32 within 2e-5, bf16 within
     one bf16 ulp of the output's scale), with each case's splits and
     CTAs (``ring_decode.decode_splits``);
  3. the paths, each with the launch counts set to 0 just before it and
     read just after:
       * ``repro_torch.load(artifact).run(x)`` on the int8 DS-CNN,
         ResNet-8, MCUNet-5fps-VWW and ToyADMOS for the 8 golden
         inputs, batched and one by one; float outputs, int8 outputs and
         final-pool sha256 equal the golden that the reference wrote
         (ToyADMOS: exactly 10 ``ring_gemm_q`` launches an inference);
       * the same on the sliced MCUNet-320KB-ImageNet plan (the
         reference's ``partial="auto"`` compile for cortex-m4, 158 ops)
         for its 2 golden inputs, at exactly 98 ``ring_conv_pw_q``, 48
         ``ring_conv_dw_q``, 10 ``ring_add_q``, 1 ``ring_avgpool_q`` and 1
         ``ring_gemm_q`` launches an inference;
       * the same on MobileNetV1-0.25 for the cortex-m4 (29 ops: 1
         ``ring_conv_k2d_q``, 13 ``ring_conv_dw_q``, 13
         ``ring_conv_pw_q``, 1 ``ring_avgpool_q`` and 1 ``ring_gemm_q``
         launches an inference) and the unsliced MCUNet-320KB-ImageNet
         for the cortex-m7 (65 ops: 36 pw, 17 dw, 10 add, pool, the 96 ->
         1000 FC), each for its 2 golden inputs;
       * the same on the fp32 DS-CNN, ResNet-8, MCUNet-5fps-VWW,
         ToyADMOS, MobileNetV1-0.25 (29 launches an inference, as its
         int8 twin's) and MCUNet-320KB-ImageNet (10
         ``ring_inverted_bottleneck``, 16 pw, 7 dw, 1 add, pool and FC
         launches an inference; 2 golden inputs each):
         outputs within the tolerance of the reference's golden
         and of the plain ``reference_forward``, each final pool within
         it of the pool the plain versions leave, channel tails exactly
         0 (ToyADMOS: exactly 10 ``ring_gemm`` launches an inference);
       * the same on whisper-tiny's MLP tower (4 fused MLP layers at
         d_model 384, d_ff 1536 over 1,500 rows, then an elementwise
         gelu), served from its params-less artifact with the weights of
         ``cases.mlp_tower_params`` (seed 0) on 2 seeded inputs: the
         golden holds 128 of the 1,500 rows, ``reference_forward`` is
         held on all of them, and every inference makes exactly 5
         launches (4 ``ring_fused_mlp``, 1 ``ring_elementwise``);
       * ``CompiledNet.stream().step(frame)`` on the DS-CNN stream and
         the GRU chain for 60 frames; every step's int8 output and the
         final pool's sha256 equal the golden;
       * the same on the two fp32 streams: every step's output within
         the tolerance of the golden, the last pool within it of the
         pool the plain versions leave over the same frames (exact on
         channel tails, unwritten lanes and the window's copy), and a
         reset replaying the first step;
       * gemma3-1b served at full width and depth (26 layers, weights
         ``cases.lm_params(cfg, 0)`` drawn on the host):
         ``ServingEngine(build_model("gemma3-1b"), params,
         cache_len=1024).generate`` on 4 seeded prompts of 8, 64, 500
         and 600 tokens (left-padded to 600, so the 512-slot local rings
         wrap in prefill and in decode), 32 new tokens, exactly 26
         ``ring_decode_attention`` launches per decode step (one per
         layer for the batch); its logits, teacher-forced on its tokens,
         within rtol 2e-2 and atol 2e-2 * max|logits| of the plain path's
         (``build_model(..., plain=True)``) at every step; and, at batch
         1, the committed full-width golden's tokens and top-64 logits
         (``cases.hold_lm_golden``);
       * after gemma3-1b is timed and freed, an LM of each other block
         kind at full width and depth, one resident at a time
         (``LM_PATHS``: its parameters, bytes on the card and host draw
         seconds printed first): recurrentgemma-2b (prompts of 8, 64, 600
         and 2,100 tokens, the last wrapping the 2,048-slot local rings in
         prefill; 8 launches a decode step), granite-moe-1b-a400m (8, 64,
         500, 600; 24 a step; the prefill's choices the capacity drops
         printed by layer), mamba2-780m (8, 64, 500, 600; no launch) and
         whisper-tiny (8, 64, 200, 400 tokens over 1,500 seeded encoder
         frames; 4 self and 4 memory launches a step), each generating 32
         tokens with exactly those launches and no other kernel, its
         logits within the plain path's tolerance at every step (a row of
         the MoE config that misses is let pass only from the step on
         where the two paths' routings, ``moe.Routing``, really sent one
         of its tokens to other experts), and the reference's committed
         full-width golden held at batch 1 (an MoE golden's misses
         likewise only where the routing went apart from the
         reference's); then each is timed (phase 4) and freed; every
         LM's host draw runs on a thread of its own from phase 1 on;
  4. timing: per-inference host-clock latency at batch 1 and 8 and
     per-step stream latency, the device-busy share of each path from
     ``torch.profiler``, and per kernel its CUDA-event time, its plain
     version's time, its bound and (fp32) the time of the PyTorch
     library call that computes the same op, at the shapes each path
     gives it (the fused bottleneck, the fp32 GRU cell and the fused MLP
     against a short sequence of calls, with the count stated; the FC
     kernels, the int8 pw, dw, k x k and streaming convs, the int8 add,
     the int8 and fp32 pool and GRU cell also op by op,
     ``PER_OP_KERNELS``); and the
     gemma3-1b path's prefill latency at batch 4, per-token decode
     latency at batch 1 and 4, its device-busy share, and
     ``ring_decode_attention`` at its two serve shapes (a 512-slot local
     ring and the 1,024-slot global cache, bf16, batch 4) and at the
     three of ``LM_DECODE_CASES`` beside its
     bound, its plain version and one
     ``F.scaled_dot_product_attention(..., enable_gqa=True)`` call; each
     other LM's prefill latency at batch 4 and per-token decode latency
     at batch 1 and 4 with its busy share and bound (weight bytes a
     decode step reads, of an MoE layer the top-k experts', at 3.35
     TB/s); and
     ``ring_fused_mlp`` on the tower's layer under its tiling and a few
     others (``MLP_TILINGS``), and ``ring_add_q`` on every int8 add of
     the plans and edge cases in each mode it may take (the row map, and
     reading first, forced where the map would do), ``ring_gemm_q``
     on every int8 FC of the plans and edge cases in both of its modes
     (``time_gemm_modes``), and ``ring_gru_cell_q`` and ``ring_gru_cell``
     on the GRU chain's cell and the GRU edge cases in both of their
     modes (``time_gru_modes``);
  5. the port's own compile pipeline, ``repro_torch.compile``, run on
     the card machine's host CPU (which has no JAX), its pass seconds
     printed beside the ``nvidia-smi`` line; then the card runs the plans
     it compiled, each with the launch counts set to 0 just before and
     read just after, and every kernel of the plan launched:
       * ``ds-cnn`` int8 for ``cortex-m4`` from the float params and
         calibration inputs the reference drew
         (``assets/ds-cnn.cortex-m4.int8.compile.npz``): program,
         certificate and ``mcu`` equal to the committed artifact's,
         activation scales within rtol ``SCALE_RTOL`` of its, and
         ``quantize_ops`` on its scales equal to its qparams bitwise;
         ``run`` on the 8 golden inputs on the card equals the plain CPU
         path bitwise (int8 and float outputs), with as many launches
         as phase 3's DS-CNN, and lies within one int8 step of the
         output scale of the golden (``COMPILED_INT8_STEPS``);
       * ``mcunet-5fps-vww`` fp32 for ``host-sim`` with its artifact's
         params, and ``ds-cnn`` fp32 with ``streaming=True``: each
         program byte-identical to its asset's, then phase 3's checks
         (the golden's tolerance, 60 steps for the stream) with phase
         3's launch counts exactly;
  6. the static verifier, lint and codegen (Slice F), on the host, then
     the card:
       * ``repro_torch.analysis.verify_program`` on each of the 14
         committed plans (timed with its schedule cache empty, then
         again warm): proven safe, with the certificate the artifact
         stores, and ``lint_artifact`` clean;
       * phase 5's three plans compiled again with ``certify="static"``:
         a certify note that begins ``static proof``, the certificate
         equal to phase 5's sim certificate and to the artifact's, then
         run on the card under phase 3's golden checks and launch
         counts; the static and the sim certify seconds side by side;
       * MCUNet-5fps-VWW and ResNet-8 compiled for ``cortex-m4``
         (planner-only) and their ``emit_c(geometry_only=True)`` units
         byte-identical to ``tests/golden/vww/`` and
         ``tests/golden/resnet8/``;
       * ``python -m repro_torch.cli --smoke`` and ``python -m
         repro_torch.analysis.cli --smoke`` as subprocesses, each exiting
         0 on a host that has no JAX;
  7. partial execution on the host: ``repro_torch.compile(
     "mcunet-320kb-imagenet", "cortex-m4", partial="auto",
     quantize=False, certify="static")`` with each pass's seconds, its
     program, partial summary (36 slices, ring 196,416 -> 125,312 B),
     certificate (0 clobbers) and ``mcu`` equal to the sliced asset's;
     then CI's partial smoke through the port's command line
     (``python -m repro_torch.cli mcunet-320kb-imagenet --target
     cortex-m7 --dtype int8 --partial auto --no-quantize --certify
     static``) as a subprocess, exit 0;
  8. traces on the card: ``run(x, trace=True)`` on DS-CNN int8, VWW fp32
     and the sliced plan, each bitwise the untraced run, its byte totals
     the certificate's reads and writes, its watermark ``pool_bytes``,
     its canonical form the CPU's, a wall time for every op (CUDA
     events), their sum printed beside phase 4's card time of the path;
     a traced 60-frame DS-CNN int8 stream whose counters after N steps
     are init + N·step, as the sim oracle counts; and ``python -m
     repro_torch.obs.cli --smoke`` in a temporary directory, exit 0;
  9. training (run after phase 4's LMs, before phase 5): gemma3-1b at
     full width and depth from the serve path's host draw
     (``cases.lm_params(cfg, 0)``, fp32 masters, mu and nu on the card),
     ``make_train_step`` with the config's remat for the golden's 3 steps
     at its batch and sequence (``cases.hold_train_golden``): the
     batches bitwise, each step's loss, grad_norm and lr and step 0's
     gradient norm of every leaf within rtol 2e-2 of the reference's
     committed full-width train golden
     (``assets/gemma3-1b.train.npz``), and no ring kernel launched; the
     state saved with ``CheckpointManager.save_async`` under ``build/``,
     restored into a fresh state (bitwise), and step 3 run from both
     (losses within rtol 1e-5); the trained tree served through
     ``ServingEngine.generate`` for 8 tokens with phase 3's checks
     against the plain path (26 ``ring_decode_attention`` launches a
     decode step); each other kind's reduced config (``TRAIN_KINDS``)
     trained 2 steps on the card and on the CPU from the same params,
     losses within rtol 2e-2; then the full-width step timed at the
     golden's 2 x 128 tokens and at 8 x 512 (median of 5 after a
     warm-up, busy share, ``max_memory_allocated``, tokens/s) beside
     its bound (``train_bound``);
 10. (after 9) gemma3-1b at full width on a one-card NCCL mesh: served,
     trained against the train golden, checkpointed and restored with
     ``shardings=``, timed beside the unsharded numbers;
 11. ``tools/mesh_check.py`` on the host CPU: 4 gloo ranks against one
     process, reduced gemma3-1b on ``data=4`` and ``(pod, data, model)
     = (2, 2, 1)``, tensor parallelism (reduced granite-moe and mamba2
     at ``(data, model) = (1, 4)`` and ``(2, 2)``, granite-moe's global
     MoE routing at ``data=4``) and sequence parallelism (reduced
     gemma3-1b and recurrentgemma-2b, ``fsdp_sp``, at the same two
     meshes);
 12. tensor parallelism on the card, the model ranks as threads of one
     process (``parallel.standin.StandInMesh``; NCCL takes one rank a
     card): granite-moe-1b-a400m at full width served through
     ``ServingEngine(rules=...)`` over 2 and 4 model ranks and
     mamba2-780m over 2 (each rank its heads, experts, ``d_ff`` and
     vocabulary rows; phase 3's prompts, 8 new tokens), each with phase
     3's checks against the plain path over the same ranks (the ranks'
     logits gathered), 24 / 0 ``ring_decode_attention`` launches a
     decode step on each rank, and its full-width golden on every rank,
     its decode per token and busy share timed beside phase 4's
     unsharded; one granite-moe train step
     over 2 model ranks (``standin_train_step``, the golden's 2 x 128
     tokens, remat ``"none"``): loss, grad_norm and update norm within
     2e-2 of the unsharded step's;
 13. sequence parallelism on the card, the ranks as threads of one
     process: gemma3-1b at full width served under the decode cell's
     rules over 2 and 4 model ranks (each rank a run of the 4 global
     caches, ``kv_seq``: 26 ``ring_decode_attention`` launches a step on
     each rank, 4 of them with ``return_lse``, the partials combined by
     their log-sum-exp) and under the long-context cell's over ``(data,
     model) = (2, 1)`` and ``(2, 2)`` at batch 1, each with the unsharded
     path's tokens, logits within the bf16 tolerance of the unsharded
     plain path's, the golden on every rank (the decode cell), each
     rank's cache bytes against the unsharded caches' and its decode
     timed; its prefill cell's sequence-sharded prefill over 2 and 4
     (last logits and caches against the unsharded prefill's) and one
     train step over 2 model ranks (``fsdp_sp``, as phase 12's);
     recurrentgemma-2b's sequence-sharded prefill of 4 x 2,100 tokens
     over 2 ranks (the window, the scan carry and the conv halo across
     them), its first rec block in fp32 over 2 and 4 ranks (every
     position and the cache within 1e-5 of the unsplit block's, the
     ``lru_lambda`` as drawn and slowed so that the carry reaches across
     a run), the slowed model's prefill over 2 in fp32 (last logits and
     caches within 1e-4), and its golden under the decode cell's rules;
     whisper-tiny's
     prefill over 2 and 4 (the encoder's 1,500 frames in runs of 750 and
     375) and its serving over 4 (``kv_seq`` on the self caches) with
     the same checks.

Then JSON lines with the paths' timings (``{"paths": ...}``, the
training step's among them), the
compile seconds (``{"compile": ...}``), phase 6's record
(``{"verify": ...}``), phase 7's and 8's (``{"partial": ...}``,
``{"traces": ...}``) and every kernel (``{"kernels": [...]}``, its
launches those of phases 3, 5, 6, 8, 9, 10, 12 and 13), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any mismatch, a failed build or launch, a missing card, or a run outside
a checkout exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
ASSETS = ROOT / "src" / "repro_torch" / "assets"
CSRC = "src/repro_torch/kernels/csrc"
#: The sliced (partial-execution) int8 plan: MCUNet-320KB-ImageNet for
#: the M4 with ``partial="auto"``, served by ``run`` beside the others.
SLICED = "mcunet-320kb-imagenet-sliced"
#: Plans served by ``run`` (int8 and fp32) and plans stepped by ``stream``;
#: an int8 plan's MCU target is ``cases.INT8_TARGETS``' (unsliced ImageNet:
#: the cortex-m7).
NETS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ad-toyadmos", SLICED,
        "mobilenetv1-0.25", "mcunet-320kb-imagenet")
FLOAT_NETS = ("ds-cnn", "resnet-8", "mcunet-5fps-vww", "ad-toyadmos",
              "mobilenetv1-0.25", "mcunet-320kb-imagenet")
STREAMS = ("ds-cnn-stream", "kws-gru-chain")
FLOAT_STREAMS = STREAMS
#: fp32 plans whose artifact holds no weights: ``mlp_tower_params`` of
#: ``SEED`` gives them, and their golden holds the outputs' ``rows``.
SEEDED_FLOAT_NETS = ("whisper-tiny-mlp",)
SEED = 0
#: An fp32 plan's label in the output (its int8 twin keeps the name).
F32 = "-f32"

#: The TPU kernel each CUDA kernel replaces.
REPLACES = {
    "ring_gemm_q": "src/repro/kernels/quantized.py:87",
    "ring_conv_pw_q": "src/repro/kernels/quantized.py:196",
    "ring_conv_dw_q": "src/repro/kernels/quantized.py:310",
    "ring_conv_k2d_q": "src/repro/kernels/quantized.py:419",
    "ring_add_q": "src/repro/kernels/quantized.py:515",
    "ring_avgpool_q": "src/repro/kernels/quantized.py:603",
    "ring_conv_stream_q": "src/repro/kernels/stream.py:235",
    "ring_gru_cell_q": "src/repro/kernels/stream.py:417",
    "ring_gemm": "src/repro/kernels/segment_matmul.py:117",
    "ring_conv_pw": "src/repro/kernels/conv2d.py:108",
    "ring_conv_dw": "src/repro/kernels/conv2d.py:225",
    "ring_conv_k2d": "src/repro/kernels/conv2d.py:336",
    "ring_add": "src/repro/kernels/conv2d.py:432",
    "ring_avgpool": "src/repro/kernels/conv2d.py:514",
    "ring_inverted_bottleneck": "src/repro/kernels/inverted_bottleneck.py:107",
    "ring_conv_stream": "src/repro/kernels/stream.py:142",
    "ring_gru_cell": "src/repro/kernels/stream.py:350",
    "ring_fused_mlp": "src/repro/kernels/fused_mlp.py:97",
    "ring_elementwise": "src/repro/kernels/elementwise.py:61",
    "ring_decode_attention": "src/repro/kernels/ring_decode.py:77",
}

#: The LM served in phase 3: its config, the decode cache length, the
#: prompts' lengths (the longest 600 > the 512-slot local window) and the
#: tokens generated.
LM = "gemma3-1b"
LM_CACHE_LEN = 1024
LM_PROMPT_LENS = (8, 64, 500, 600)
LM_MAX_NEW = 32

#: Phase 5: the rtol within which the port's activation scales hold
#: the reference's, and the int8 steps of the output scale within which
#: the port-calibrated DS-CNN's float outputs hold the golden (the
#: builder's CPU run: 0.00216 of a 0.00217 step, 8 inputs, 5 of 96
#: int8 outputs one step off).
SCALE_RTOL = 1e-5
COMPILED_INT8_STEPS = 1
#: A phase-5 path's label: its phase-3 twin's, with this suffix.
COMPILED = "-compiled"
#: A phase-6 path's label: its phase-5 twin's, with this suffix.
STATIC = "-static"

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15          # tensor cores: int8 multiply-adds
CUDA_CORE_OPS_PER_S = 67e12        # outside the tensor cores: fp32 FMA
DEVICE_TYPE = "cuda"               # where every path's outputs must lie


#: The script's start on the host clock: each phase's first line says
#: how many seconds had passed.
T0 = time.perf_counter()


def say(*args) -> None:
    if args and str(args[0]).startswith("phase"):
        args = (*args, f"[{time.perf_counter() - T0:.1f} s in]")
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _asset(label: str) -> str:
    """The asset stem of a path label."""
    from repro_torch.kernels.cases import int8_stem

    if label.endswith(F32):
        return f"{label.removesuffix(F32)}.host-sim.float32"
    return int8_stem(label)


def artifact(label: str) -> pathlib.Path:
    return ASSETS / f"{_asset(label)}.json"


def load_golden(label: str, cn) -> dict:
    """Plan ``cn``'s golden; a seeded plan's inputs are drawn again from
    ``SEED`` and held to the sha256 the golden keeps."""
    with np.load(ASSETS / f"{_asset(label)}.golden.npz") as g:
        golden = {k: g[k] for k in g.files}
    if "x_sha256" in golden:
        x = np.random.default_rng(SEED).standard_normal(
            (len(golden["y"]), cn.program.m_rows, cn.program.in_dim),
            np.float32)
        if hashlib.sha256(x.tobytes()).hexdigest() != str(golden["x_sha256"]):
            raise SystemExit(f"{label}: the seeded inputs differ from the "
                             "golden's")
        golden["x"] = x
    return golden


def load_plan(label: str):
    """A plan from its artifact (a seeded plan with its seeded weights)."""
    import repro_torch
    from repro_torch.kernels.cases import seeded_float_net

    if label.removesuffix(F32) in SEEDED_FLOAT_NETS:
        return seeded_float_net(artifact(label), SEED)
    return repro_torch.load(artifact(label))


def params_of(cn):
    """A loaded plan's weight entries (numpy): int8 qparams or fp32
    params."""
    return cn.qnet.qparams if cn.quantized else cn.params


# ---------------------------------------------------------------------------
# Bounds: bytes moved once and operations done, from a kernel call's shapes.
# ---------------------------------------------------------------------------

def _segs(d: int) -> int:
    return -(-d // 128)


def _conv_taps(k, stride, padding, h_in, w_in, h_out, w_out) -> int:
    """In-bounds taps of a k x k conv over all output pixels."""
    from repro_torch.core.rowsched import conv_k2d_pad, conv_k2d_pad_w

    pv, ph = conv_k2d_pad(k, padding), conv_k2d_pad_w(k, padding)
    rows_ok = [sum(0 <= p * stride - pv + r < h_in for r in range(k))
               for p in range(h_out)]
    cols_ok = [sum(0 <= q * stride - ph + t < w_in for t in range(k))
               for q in range(w_out)]
    return sum(rows_ok) * sum(cols_ok)


def _conv_pixels_read(k, stride, padding, h_in, w_in, h_out, w_out) -> int:
    """Input pixels that some in-bounds tap of a k x k conv reads."""
    from repro_torch.core.rowsched import conv_k2d_pad, conv_k2d_pad_w

    pv, ph = conv_k2d_pad(k, padding), conv_k2d_pad_w(k, padding)
    rows = {p * stride - pv + r for p in range(h_out) for r in range(k)}
    cols = {q * stride - ph + t for q in range(w_out) for t in range(k)}
    return (len(rows & set(range(h_in))) * len(cols & set(range(w_in))))


def _pw_pixels_read(kw) -> int:
    """Input pixels a 1x1 conv reads (strided or resampled picks)."""
    from repro_torch.core.rowsched import resample_src

    def picks(n_in, n_out):
        if kw.get("resample"):
            return {resample_src(p, n_in, n_out) for p in range(n_out)}
        return {p * kw.get("stride", 1) for p in range(n_out)}
    return len(picks(kw["h_in"], kw["h_out"])) \
        * len(picks(kw["w_in"], kw["w_out"]))


def work(kernel: str, kw: dict) -> tuple[int, int, int]:
    """``(bytes, tensor_ops, core_ops)`` a kernel call must move and do.

    Bytes: every input pixel the op reads, once, at its data width (its
    live channels, not the whole segments it sits in); every output row
    written once as whole segments (the kernels must store the channel
    tails as zeros); the streaming window read once at its data width
    and written back once as whole segments (as the reference copies
    the window's segments, and as :func:`work_f32` counts it); weights,
    biases and requant constants once.
    Int8 operations: 2 int8 ops per multiply-accumulate at in-bounds
    taps (tensor cores); elementwise integer ops (the pool's adds, the
    residual add's two requantizations and sum) counted apart, for the
    CUDA cores.  An fp32 kernel's work is :func:`work_f32`'s."""
    if kernel == "ring_avgpool_q":
        rows = kw["h"] * kw["w"]
        return rows * kw["c"] + _segs(kw["c"]) * 128, 0, rows * kw["c"]
    if kernel == "ring_add_q":
        rows, d = kw["rows"], kw["d"]
        return 2 * rows * d + rows * _segs(d) * 128, 0, 3 * rows * d
    if kernel == "ring_gemm_q":
        m, ci, co = kw["m_rows"], kw["d_in"], kw["d_out"]
        return (m * ci + m * _segs(co) * 128 + ci * co + 12 * co,
                2 * m * ci * co, 0)
    if kernel == "ring_gru_cell_q":
        ci, dh = kw["d_in"], kw["d_h"]
        g = 3 * dh
        # x and h read once; h' stored to the state and to the output.
        return (ci + dh + 2 * _segs(dh) * 128 + (ci + dh) * g + 20 * g,
                2 * (ci + dh) * g, 0)
    if kernel == "ring_conv_stream_q":
        ci, co, k = kw["c_in"], kw["c_out"], kw["k"]
        win = kw["h_win"] * kw["w_in"] * ci
        out = kw["h_out"] * kw["w_out"] * _segs(co) * 128
        taps = _conv_taps(k, kw["stride"], kw["padding"], kw["h_win"],
                          kw["w_in"], kw["h_out"], kw["w_out"])
        win_segs = kw["h_win"] * kw["w_in"] * _segs(ci) * 128
        return win + win_segs + out + k * k * ci * co + 12 * co, \
            2 * taps * ci * co, 0
    ci = kw["c"] if kernel == "ring_conv_dw_q" else kw["c_in"]
    co = kw["c"] if kernel == "ring_conv_dw_q" else kw["c_out"]
    out = kw["h_out"] * kw["w_out"] * _segs(co) * 128 + 12 * co
    if kernel == "ring_conv_pw_q":
        return (_pw_pixels_read(kw) * ci + out + ci * co,
                2 * kw["h_out"] * kw["w_out"] * ci * co, 0)
    k = kw["rs"] if kernel == "ring_conv_dw_q" else kw["k"]
    geom = (k, kw["stride"], kw["padding"], kw["h_in"], kw["w_in"],
            kw["h_out"], kw["w_out"])
    io = _conv_pixels_read(*geom) * ci + out
    taps = _conv_taps(*geom)
    if kernel == "ring_conv_dw_q":
        return io + k * k * ci, 2 * taps * ci, 0
    return io + k * k * ci * co, 2 * taps * ci * co, 0


def work_f32(kernel: str, kw: dict) -> tuple[int, int]:
    """``(bytes, ops)`` an fp32 kernel call must move and do: as
    :func:`work`, at 4 bytes per element (the bias, 4 bytes per output
    channel, is the only per-channel constant); 2 fp32 operations per
    multiply-accumulate at in-bounds taps, 1 per add or division and 1
    per activation.  The fused bottleneck reads each input pixel once
    (its residual re-read is not counted) and does 2 operations per
    multiply-accumulate of its three products; the streaming conv reads
    its window once at its data width, writes it back as whole segments
    (as the reference's copy of the window's segments does) and does
    2 k^2 c_in c_out operations per output pixel; the GRU cell reads x and h
    once, stores h' twice as whole segments and does 2 (d_in + d_h) 3
    d_h operations; the fused MLP (``kw`` with its ``d_ff``) reads its
    rows once at their data width, stores them as whole segments, reads
    each weight once (W_gate only when gated) and does 2 operations per
    multiply-accumulate of its two (three) products, 1 per activation,
    gate product, tile sum and residual add; the elementwise map reads
    its rows at their data width, stores them as whole segments and does
    1 operation per live element."""
    if kernel == "ring_fused_mlp":
        m, d, f = kw["m_rows"], kw["d_model"], kw["d_ff"]
        mats = 3 if kw["gated"] else 2
        return (4 * (m * d + m * _segs(d) * 128 + mats * d * f),
                2 * mats * m * d * f + (2 if kw["gated"] else 1) * m * f
                + m * d * (f // kw["ff_tile"]) + m * d * kw["residual"])
    if kernel == "ring_elementwise":
        m, d = kw["m_rows"], kw["d"]
        return 4 * (m * d + m * _segs(d) * 128), m * d
    if kernel == "ring_inverted_bottleneck":
        pix, ci, cm, co = kw["H"] * kw["W"], kw["C_in"], kw["C_mid"], \
            kw["C_out"]
        mid = ci * cm + kw["RS"] ** 2 * cm + cm * co
        return 4 * (pix * ci + pix * 128 + mid), 2 * pix * mid
    if kernel == "ring_conv_stream":
        ci, co, k = kw["c_in"], kw["c_out"], kw["k"]
        win, pix = kw["h_win"] * kw["w_in"] * ci, kw["h_out"] * kw["w_out"]
        win_segs = kw["h_win"] * kw["w_in"] * _segs(ci) * 128
        return (4 * (win + win_segs + pix * _segs(co) * 128
                     + k * k * ci * co + co),
                2 * k * k * ci * co * pix)
    if kernel == "ring_gru_cell":
        ci, dh = kw["d_in"], kw["d_h"]
        g = 3 * dh
        return (4 * (ci + dh + 2 * _segs(dh) * 128 + (ci + dh) * g + g),
                2 * (ci + dh) * g)
    if kernel == "ring_avgpool":
        rows, c = kw["h"] * kw["w"], kw["c"]
        return 4 * (rows * c + _segs(c) * 128), rows * c + c
    if kernel == "ring_add":
        rows, d = kw["rows"], kw["d"]
        return 4 * (2 * rows * d + rows * _segs(d) * 128), 2 * rows * d
    if kernel == "ring_gemm":
        m, ci, co = kw["m_rows"], kw["d_in"], kw["d_out"]
        return (4 * (m * ci + m * _segs(co) * 128 + ci * co + co),
                2 * m * ci * co + 2 * m * co)
    ci = kw["c"] if kernel == "ring_conv_dw" else kw["c_in"]
    co = kw["c"] if kernel == "ring_conv_dw" else kw["c_out"]
    pix = kw["h_out"] * kw["w_out"]
    out = 4 * (pix * _segs(co) * 128 + co)
    if kernel == "ring_conv_pw":
        return (out + 4 * (_pw_pixels_read(kw) * ci + ci * co),
                2 * pix * ci * co + 2 * pix * co)
    k = kw["rs"] if kernel == "ring_conv_dw" else kw["k"]
    geom = (k, kw["stride"], kw["padding"], kw["h_in"], kw["w_in"],
            kw["h_out"], kw["w_out"])
    io = out + 4 * _conv_pixels_read(*geom) * ci
    taps = _conv_taps(*geom)
    if kernel == "ring_conv_dw":
        return io + 4 * k * k * ci, 2 * taps * ci + 2 * pix * co
    return io + 4 * k * k * ci * co, 2 * taps * ci * co + 2 * pix * co


def bound(kernel: str, kw: dict) -> tuple[float, str]:
    if kernel.endswith("_q"):
        nbytes, tensor_ops, core_ops = work(kernel, kw)
    else:
        (nbytes, core_ops), tensor_ops = work_f32(kernel, kw), 0
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tensor_ops / INT8_OPS_PER_S + core_ops / CUDA_CORE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels._build import build_all, library

    t0 = time.perf_counter()
    builds = build_all()
    say(f"phase 1: {len(builds)} sources built for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s, one nvcc each, in parallel")
    for stem, b in builds.items():
        how = f"nvcc {b.seconds:.2f} s" if b.compiled else "already built"
        say(f"  {b.path.name} ({how})")
        for line in b.ptxas_lines:
            say(f"    {line}")
        library(stem)


def _cuda(arrays):
    return tuple(torch.from_numpy(a).cuda() for a in arrays)


def plan_cases(label: str, cn):
    """One case per op of a loaded plan, named after the plan."""
    from repro_torch.kernels.cases import program_cases

    return program_cases(cn.program, params_of(cn),
                         kernel_block_rows=cn.target.kernel_block_rows,
                         prefix=f"{label}_")


def phase_parity(cases) -> dict[str, float]:
    """Every case: kernel vs plain version on the card, int8 bitwise and
    fp32 by ``cases.compare_f32``; and the cases whose launch read its
    weights from global memory, as the wrapper decided
    (``<wrapper>.weights_staged``); and the tiling of each depthwise,
    k x k and streaming fp32 conv, of each int8 pw, dw and k x k conv, of
    each fp32 add, of each fused bottleneck and each int8 add's, int8
    FC's and int8 and fp32 GRU cell's mode, which the wrapper must have
    taken (``ring_add_q.barrier``, ``ring_gemm_q.barrier``,
    ``ring_gru_cell_q.barrier``, ``ring_gru_cell.barrier``), and each
    int8 and fp32 pool's CTA.  Returns the max |difference| per kernel (0
    for int8, or this raises)."""
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.kernels.cases import (case_inputs, compare_f32, is_f32,
                                           live_lanes, output_regions)
    from repro_torch.kernels.conv2d import add_tiling, conv_tiling, \
        pool_tiling
    from repro_torch.kernels.elementwise import ew_blocks, ring_runs
    from repro_torch.kernels.inverted_bottleneck import ib_tiling
    from repro_torch.kernels.quantized import (add_map_rows,
                                               add_needs_barrier,
                                               gemm_q_tiling, pool_q_tiling)
    from repro_torch.kernels.segment_matmul import gemm_tiling
    from repro_torch.kernels.stream import gru_q_tiling, gru_tiling

    n_f32 = sum(is_f32(c.kernel) for c in cases)
    say(f"phase 2: {len(cases)} kernel calls against their plain versions "
        f"on the card ({len(cases) - n_f32} int8 bitwise, {n_f32} fp32 "
        "within the tolerance; TF32 off)")
    err: dict[str, float] = {name: 0 for name in KERNELS}
    global_w, tiles = [], []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for case in cases:
        barrier = None
        if case.kernel in ("ring_conv_pw", "ring_conv_dw", "ring_conv_k2d",
                           "ring_conv_stream", "ring_conv_pw_q",
                           "ring_conv_dw_q", "ring_conv_k2d_q",
                           "ring_conv_stream_q"):
            t = conv_tiling(case.kernel, case.kwargs, n_sm)
            tiles.append(f"{case.name} {t.ctas} CTAs, {t.held} B held")
        elif case.kernel == "ring_add":
            t = add_tiling(case.kwargs["rows"], case.kwargs["d"], n_sm)
            tiles.append(f"{case.name} {t.ctas} CTAs, {t.held} B held")
        elif case.kernel == "ring_add_q":
            kw, n = case.kwargs, case.n_seg
            rows, d = kw["rows"], kw["d"]
            barrier = add_needs_barrier(n, rows, d, kw["in_ptr"] % n,
                                        kw["aux_ptr"] % n, kw["out_ptr"] % n)
            if barrier:
                t = add_tiling(rows, d, n_sm, "ring_add_q")
                tiles.append(f"{case.name} read first: {t.ctas} CTAs, "
                             f"{t.held} B held")
            else:
                tiles.append(f"{case.name} row map, no barrier: "
                             f"{-(-rows // add_map_rows(d))} CTAs of "
                             f"{add_map_rows(d)} rows, 0 B held")
        elif case.kernel == "ring_gemm":
            kw = case.kwargs
            t = gemm_tiling(kw["m_rows"], kw["d_in"], kw["d_out"], n_sm)
            tiles.append(f"{case.name} {t.ctas} CTAs ({t.rows} rows x "
                         f"{t.ctile} columns), {t.held} B held")
        elif case.kernel == "ring_gemm_q":
            kw = case.kwargs
            t = gemm_q_tiling(kw["m_rows"], kw["d_in"], kw["d_out"], n_sm)
            barrier = t.barrier
            tiles.append(f"{case.name} "
                         + ("grid barrier, cooperative" if barrier else
                            "one CTA, ordinary launch")
                         + f": {t.ctas} CTAs ({t.rows} rows x {t.ctile} "
                         f"columns), {t.held} B held")
        elif case.kernel == "ring_gru_cell_q":
            kw = case.kwargs
            t = gru_q_tiling(kw["d_in"], kw["d_h"], n_sm)
            barrier = t.barrier
            tiles.append(f"{case.name} "
                         + ("grid barrier, cooperative" if barrier else
                            "one CTA, ordinary launch")
                         + f": {t.ctas} CTAs of {t.ctile} hidden channels, "
                         f"{t.smem} B of shared memory")
        elif case.kernel == "ring_gru_cell":
            kw = case.kwargs
            t = gru_tiling(kw["d_in"], kw["d_h"], n_sm)
            barrier = t.barrier
            tiles.append(f"{case.name} "
                         + ("grid barrier, cooperative" if barrier else
                            "one CTA, ordinary launch")
                         + f": {t.ctas} CTAs of {t.ctile} hidden channels, "
                         f"k split {t.lanes}, {t.smem} B of shared memory")
        elif case.kernel in ("ring_avgpool_q", "ring_avgpool"):
            kw = case.kwargs
            t = (pool_q_tiling if case.kernel == "ring_avgpool_q"
                 else pool_tiling)(kw["h"], kw["w"], kw["c"])
            tiles.append(f"{case.name} one CTA of {t.threads} threads, "
                         f"ordinary launch: {t.parts} part(s) of each "
                         f"channel's sum, {t.chunk_pix} of {t.npix} pixels "
                         f"a chunk, {t.smem} B of shared memory")
        elif case.kernel == "ring_elementwise":
            kw = case.kwargs
            n = kw["m_rows"] * _segs(kw["d"])
            runs = ring_runs(case.n_seg, kw["ptr"] % case.n_seg, n)
            tiles.append(f"{case.name} runs (start, segments) {runs}, "
                         f"{ew_blocks(n, n_sm)} blocks")
        elif case.kernel == "ring_inverted_bottleneck":
            t = ib_tiling(case.kwargs, n_sm)
            tiles.append(f"{case.name} {t.ctas} CTAs, {t.held} B held "
                         f"({t.rows} x {t.cols} pixels in sub-tiles of "
                         f"{t.sub_rows} x {t.sub_cols})")
        pool, params = case_inputs(case, seed=0)
        want = torch.from_numpy(pool).cuda()
        PLAIN[case.kernel](want, *_cuda(params), **case.kwargs)
        got = torch.from_numpy(pool).cuda()
        KERNELS[case.kernel](got, *_cuda(params), **case.kwargs)
        if KERNELS[case.kernel].weights_staged is False:
            global_w.append(case.name)
        if barrier is not None and KERNELS[case.kernel].barrier != barrier:
            raise SystemExit(f"{case.name}: {case.kernel} took barrier="
                             f"{KERNELS[case.kernel].barrier}, not {barrier}")
        if case.kernel == "ring_fused_mlp":
            t = KERNELS[case.kernel].tiles
            tiles.append(f"{case.name} {t.ctas} CTAs ({t.rows}-row blocks x "
                         f"{t.n_sub} sub-tiles of {t.sub} d_ff columns), "
                         f"{t.smem} B of shared memory, {t.scratch_bytes} B "
                         "of scratch")
        torch.cuda.synchronize()
        if is_f32(case.kernel):
            live = live_lanes(case.n_seg,
                              output_regions(case.kernel, case.kwargs))
            e, bad = compare_f32(got.cpu().numpy(), want.cpu().numpy(),
                                 live)
            err[case.kernel] = max(err[case.kernel], e)
            if bad:
                raise SystemExit(f"{case.name}: {case.kernel} differs from "
                                 f"its plain version, {bad}")
            continue
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        err[case.kernel] = max(err[case.kernel], int(diff.max()))
        if not torch.equal(got, want):
            seg = int(diff.amax(dim=1).nonzero()[0])
            raise SystemExit(f"{case.name}: {case.kernel} differs from its "
                             f"plain version, first at segment {seg}")
    covered = sorted({c.kernel for c in cases})
    say(f"  int8 all bitwise equal, fp32 all within the tolerance; max "
        f"|difference| per fp32 kernel: "
        f"{ {k: err[k] for k in covered if not k.endswith('_q')} }")
    say(f"  kernels covered: {covered}")
    say(f"  weights read from global memory (too large for shared, used "
        f"once, or streamed through it in chunks): "
        f"{global_w or 'none'}")
    say(f"  ring_gemm / ring_conv_pw / ring_conv_dw / ring_conv_k2d / "
        f"ring_conv_stream / ring_add / ring_inverted_bottleneck / "
        f"ring_conv_pw_q / ring_conv_dw_q / ring_conv_k2d_q / "
        f"ring_conv_stream_q tiles on {n_sm} SMs (CTAs, bytes each holds "
        "across the grid barrier), ring_gemm_q's, ring_gru_cell_q's, "
        "ring_gru_cell's and ring_add_q's mode, CTAs and bytes held, "
        "ring_avgpool_q's and ring_avgpool's CTA, "
        "ring_elementwise's runs and blocks, and "
        "ring_fused_mlp's (CTAs of its first kernel, tiling, scratch):")
    for line in tiles:
        say(f"    {line}")
    return err


def _path_kernels(cn) -> set[str]:
    """The kernels a plan's ops launch."""
    from repro_torch.core.executors import op_kernel_call

    return {op_kernel_call(cn.program, op, p)[0]
            for op, p in zip(cn.program.ops, params_of(cn))}


def _counted(label: str, cn, runs: int, unit: str,
             drive) -> dict[str, int]:
    """Run ``drive()`` (``runs`` inferences or steps) with the launch
    counts set to 0 just before and read just after; every kernel of the
    plan must have launched."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    drive()
    torch.cuda.synchronize()
    counts = launch_counts()
    missing = sorted(k for k in _path_kernels(cn) if not counts[k])
    if missing:
        raise SystemExit(f"{label}: kernels never launched: {missing}")
    say(f"  {label} launches: {({k: n for k, n in counts.items() if n})} "
        f"({sum(counts.values()) / runs:g} per {unit})")
    return counts


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def path_serve(name: str, cn, golden) -> dict[str, int]:
    """``run`` on the card: 8 inputs batched and 8 one by one, equal to
    the golden in float outputs, int8 outputs and final-pool sha256."""
    from repro_torch.compile.artifact import to_device
    from repro_torch.core.executors import run_program
    from repro_torch.quant.qtensor import QParams, quantize

    x = torch.from_numpy(golden["x"]).cuda()
    out = {}

    def drive():
        out["batch"] = cn.run(x)
        out["single"] = [cn.run(xi) for xi in x]

    counts = _counted(f"{name} run", cn, 2 * len(x), "inference", drive)
    _exact_launches(name, counts, 2 * len(x))
    want = torch.from_numpy(golden["y"]).cuda()
    if out["batch"].device.type != DEVICE_TYPE \
            or not torch.equal(out["batch"], want):
        raise SystemExit(f"{name}: batched float outputs differ from the "
                         "golden")
    for i, y in enumerate(out["single"]):
        if not torch.equal(y, want[i]):
            raise SystemExit(f"{name}: float output {i} differs from the "
                             "golden")
    qparams = to_device(cn.qnet.qparams, x.device)
    for i, xi in enumerate(x):
        xq = quantize(xi, QParams(scale=cn.qnet.in_scale))
        y_q, pool = run_program(cn.program, xq, qparams,
                                kernel_block_rows=cn.target.kernel_block_rows)
        if not np.array_equal(y_q.cpu().numpy(), golden["y_q"][i]):
            raise SystemExit(f"{name}: int8 output {i} differs from the "
                             "golden")
        if _sha(pool.array) != golden["pool_sha256"][i]:
            raise SystemExit(f"{name}: final pool {i} differs from the "
                             "golden")
    say(f"  {name}: {tuple(out['batch'].shape)} float outputs, int8 outputs "
        f"and final-pool sha256 equal the golden on all {len(x)}")
    return counts


def _within(got: np.ndarray, want: np.ndarray) -> bool:
    from repro_torch.kernels.cases import ATOL_REL, RTOL

    scale = float(np.abs(want).max()) or 1.0
    return bool(np.all(np.abs(got - want) <= ATOL_REL * scale
                       + RTOL * np.abs(want)))


#: Launches per inference that a path must make exactly, per kernel.
LAUNCHES_PER_INFERENCE = {
    "ad-toyadmos": {"ring_gemm_q": 10},
    SLICED: {"ring_conv_pw_q": 98, "ring_conv_dw_q": 48, "ring_add_q": 10,
             "ring_avgpool_q": 1, "ring_gemm_q": 1},
    "mobilenetv1-0.25": {"ring_conv_k2d_q": 1, "ring_conv_dw_q": 13,
                         "ring_conv_pw_q": 13, "ring_avgpool_q": 1,
                         "ring_gemm_q": 1},
    "mcunet-320kb-imagenet": {"ring_conv_pw_q": 36, "ring_conv_dw_q": 17,
                              "ring_add_q": 10, "ring_avgpool_q": 1,
                              "ring_gemm_q": 1},
    "ad-toyadmos" + F32: {"ring_gemm": 10},
    "mobilenetv1-0.25" + F32: {"ring_conv_k2d": 1, "ring_conv_dw": 13,
                               "ring_conv_pw": 13, "ring_avgpool": 1,
                               "ring_gemm": 1},
    "mcunet-320kb-imagenet" + F32: {"ring_inverted_bottleneck": 10,
                                    "ring_conv_pw": 16, "ring_conv_dw": 7,
                                    "ring_add": 1, "ring_avgpool": 1,
                                    "ring_gemm": 1},
    "whisper-tiny-mlp" + F32: {"ring_fused_mlp": 4, "ring_elementwise": 1},
}


def _exact_launches(label: str, counts: dict[str, int], runs: int) -> None:
    """A path with a fixed number of launches per inference must make
    exactly that many of each kernel, and no other."""
    exact = LAUNCHES_PER_INFERENCE.get(label)
    if exact is not None and {k: n for k, n in counts.items() if n} \
            != {k: n * runs for k, n in exact.items()}:
        raise SystemExit(f"{label}: launches {counts} are not {exact} per "
                         "inference")


def path_serve_f32(label: str, cn, golden) -> dict[str, int]:
    """``run`` of an fp32 plan on the card: the golden inputs batched and
    one by one, within the tolerance of the golden (on its ``rows`` where
    it holds only some) and of the plain ``reference_forward`` on every
    row; each input's final pool within the tolerance of the plain
    versions' pool, channel tails and unwritten lanes exactly equal, the
    tails of every live row exactly 0."""
    from repro_torch.compile.artifact import to_device
    from repro_torch.core.executors import run_program
    from repro_torch.graph.run import reference_forward
    from repro_torch.kernels.cases import (compare_f32, plain_pool,
                                           program_live_lanes)

    x = torch.from_numpy(golden["x"]).cuda()
    out = {}

    def drive():
        out["batch"] = cn.run(x)
        out["single"] = [cn.run(xi) for xi in x]

    counts = _counted(f"{label} run", cn, 2 * len(x), "inference", drive)
    _exact_launches(label, counts, 2 * len(x))
    if out["batch"].device.type != DEVICE_TYPE:
        raise SystemExit(f"{label}: outputs left the card")
    batch = out["batch"].cpu().numpy()
    shown = batch if "rows" not in golden else batch[:, golden["rows"]]
    if not _within(shown, golden["y"]):
        raise SystemExit(f"{label}: outputs differ from the golden by "
                         f"{np.abs(shown - golden['y']).max():.3g}")
    for i, y in enumerate(out["single"]):
        if not torch.equal(y, out["batch"][i]):
            raise SystemExit(f"{label}: single run {i} differs from the "
                             "batched one")
    kbr = cn.target.kernel_block_rows
    params = to_device(cn.params, x.device)
    ref = torch.stack([reference_forward(cn.program, xi, params)
                       for xi in x]).cpu().numpy()
    if not _within(batch, ref):
        raise SystemExit(f"{label}: outputs differ from reference_forward "
                         f"by {np.abs(batch - ref).max():.3g}")
    live = program_live_lanes(cn.program, cn.params, kernel_block_rows=kbr)
    worst = 0.0
    for i, xi in enumerate(x):
        _, pool = run_program(cn.program, xi, params, kernel_block_rows=kbr)
        got = pool.array.cpu().numpy()
        want = plain_pool(cn.program, xi, cn.params,
                          kernel_block_rows=kbr).cpu().numpy()
        err, bad = compare_f32(got, want, live)
        if bad:
            raise SystemExit(f"{label}: final pool {i} differs from the "
                             f"plain path's, {bad}")
        if got[~live].any():
            raise SystemExit(f"{label}: final pool {i} has a nonzero "
                             "channel tail or unwritten lane")
        worst = max(worst, err)
    rows = "" if "rows" not in golden else \
        f" on its {len(golden['rows'])} rows"
    say(f"  {label}: {batch.shape} outputs within the tolerance of the "
        f"golden{rows} (max |difference| "
        f"{np.abs(shown - golden['y']).max():.3g}) and of reference_forward"
        f" (max {np.abs(batch - ref).max():.3g}); final pools within it of "
        f"the plain path's (max {worst:.3g}), channel tails 0, on all "
        f"{len(x)}")
    return counts


def path_stream(name: str, cn, golden) -> dict[str, int]:
    """``stream().step`` on the card for every golden frame: each step's
    int8 output and the last pool equal the golden; then float frames
    give the dequantized golden."""
    frames = torch.from_numpy(golden["x_q"]).cuda()
    session = cn.stream()
    ys = []
    counts = _counted(f"{name} stream", cn, len(frames), "step",
                      lambda: ys.extend(session.step(f) for f in frames))
    for i, y in enumerate(ys):
        if y.device.type != DEVICE_TYPE \
                or not np.array_equal(y.cpu().numpy(), golden["y_q"][i]):
            raise SystemExit(f"{name}: step {i} differs from the golden")
    if _sha(session.pool.array) != str(golden["pool_sha256"]):
        raise SystemExit(f"{name}: the pool after {len(ys)} steps differs "
                         "from the golden")
    session.reset()
    for i, f in enumerate(golden["x"][:8]):
        if not np.array_equal(session.step(f).cpu().numpy(),
                              golden["y"][i]):
            raise SystemExit(f"{name}: float step {i} differs from the "
                             "golden")
    say(f"  {name}: {len(ys)} steps, every int8 output and the final pool "
        f"equal the golden ({session.state_bytes} B of state)")
    return counts


def path_stream_f32(label: str, cn, golden) -> dict[str, int]:
    """``stream().step`` of an fp32 streaming plan on the card for every
    golden frame: each step's output within the tolerance of the golden;
    the last pool within it of the pool the plain versions leave over
    the same frames on the card, exactly equal on channel tails,
    unwritten lanes and the window (a copy), the window's tails 0; and
    a reset replays the first step bit for bit."""
    from repro_torch.kernels.cases import (compare_f32, plain_pool,
                                           program_live_lanes)

    frames = [torch.from_numpy(f).cuda() for f in golden["x"]]
    session = cn.stream()
    ys = []
    counts = _counted(f"{label} stream", cn, len(frames), "step",
                      lambda: ys.extend(session.step(f) for f in frames))
    worst = 0.0
    for i, y in enumerate(ys):
        got = y.cpu().numpy()
        if y.device.type != DEVICE_TYPE or not _within(got, golden["y"][i]):
            raise SystemExit(f"{label}: step {i} differs from the golden by "
                             f"{np.abs(got - golden['y'][i]).max():.3g}")
        worst = max(worst, float(np.abs(got - golden["y"][i]).max()))
    kbr = cn.target.kernel_block_rows
    want = plain_pool(cn.program, frames, cn.params, kernel_block_rows=kbr)
    live = program_live_lanes(cn.program, cn.params, kernel_block_rows=kbr)
    got = session.pool.array.cpu().numpy()
    err, bad = compare_f32(got, want.cpu().numpy(), live)
    if bad:
        raise SystemExit(f"{label}: the pool after {len(ys)} steps differs "
                         f"from the plain path's, {bad}")
    win = cn.program.ops[0]
    window = got[win.state_ptr:win.state_ptr + win.state_segments]
    if window[:, win.d_in:].any():
        raise SystemExit(f"{label}: a window channel tail is not 0")
    first = ys[0].clone()
    session.reset()
    if not torch.equal(session.step(frames[0]), first):
        raise SystemExit(f"{label}: the first step after reset differs")
    say(f"  {label}: {len(ys)} steps, every output within the tolerance of "
        f"the golden (max |difference| {worst:.3g}); the last pool within "
        f"it of the plain path's (max {err:.3g}), exact elsewhere; reset "
        f"replays ({session.state_bytes} B of state)")
    return counts


def _event_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` back-to-back calls
    (the plain versions: host and device time together)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _held_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls.

    The stream first spins long enough for the host to enqueue every
    call before the card reaches the first, so the events time the
    kernels alone and not the host's launch rate.  The spin grows until
    it outlasts the enqueue."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        held = not start.query()
        end.record()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise SystemExit(f"the stream hold never outlasted the host's enqueue "
                     f"({enqueue_ms:.2f} ms for {reps} calls)")


def _host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


#: Each wrapper's CUDA kernels, as the profiler names them: the first is
#: launched once a wrapper call, and the row's device time is the sum of
#: them all.
KERNEL_SYMBOLS = {"ring_gemm_q": "gemm_q_kernel",
                  "ring_conv_pw_q": "conv_pw_q_kernel",
                  "ring_conv_dw_q": "conv_dw_q_kernel",
                  "ring_conv_k2d_q": "conv_k2d_q_kernel",
                  "ring_add_q": "add_q_kernel",
                  "ring_avgpool_q": "avgpool_q_kernel",
                  "ring_conv_stream_q": "conv_stream_q_kernel",
                  "ring_gru_cell_q": "gru_q_kernel",
                  "ring_gemm": "gemm_f32_kernel",
                  "ring_conv_pw": "conv_pw_f32_kernel",
                  "ring_conv_dw": "conv_dw_f32_kernel",
                  "ring_conv_k2d": "conv_k2d_f32_kernel",
                  "ring_add": "add_f32_kernel",
                  "ring_avgpool": "avgpool_f32_kernel",
                  "ring_inverted_bottleneck": "ib_f32_kernel",
                  "ring_conv_stream": "conv_stream_f32_kernel",
                  "ring_gru_cell": "gru_f32_kernel",
                  "ring_fused_mlp": ("fused_mlp_f32_kernel",
                                     "mlp_reduce_f32_kernel"),
                  "ring_elementwise": "elementwise_f32_kernel",
                  "ring_decode_attention": ("ring_decode_kernel",
                                            "ring_decode_combine_kernel")}


def _device_busy(fn, reps: int = 20):
    """From torch.profiler over ``reps`` calls of ``fn``: the device time
    of all kernels over the wall time (None when the profiler sees no
    device time), the wall time per call in us, each ring kernel's mean
    device time per launch in ms, and, for a wrapper of several kernels,
    each one's share of it in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    per_launch, parts = {}, {}
    for name, syms in KERNEL_SYMBOLS.items():
        syms = (syms,) if isinstance(syms, str) else syms
        hits = [[e for e in kernels if sym + "(" in e.key
                 or sym + "<" in e.key] for sym in syms]
        calls = sum(e.count for e in hits[0])
        if calls:
            each = [sum(e.self_device_time_total for e in h) / calls / 1e3
                    for h in hits]
            per_launch[name] = sum(each)
            if len(each) > 1:
                parts[name] = each
    return ((busy_us / wall_us if busy_us > 0 else None), wall_us / reps,
            per_launch, parts)


def _library_ib(pool, params, kw):
    """The fused bottleneck as PyTorch calls on the gathered image: 1x1
    conv, relu, grouped RS x RS conv, relu, 1x1 conv (and the residual
    add); returns the function and its number of calls."""
    import torch.nn.functional as F

    from repro_torch.core.vpool import fetch_rows

    w1, wd, w2 = params
    H, W, ci, cm, co = kw["H"], kw["W"], kw["C_in"], kw["C_mid"], kw["C_out"]
    a = fetch_rows(pool, kw["in_ptr"], H * W, ci).reshape(1, H, W, ci) \
        .permute(0, 3, 1, 2).contiguous()
    k1 = w1.t().reshape(cm, ci, 1, 1).contiguous()
    kd = wd.permute(2, 0, 1)[:, None].contiguous()
    k2 = w2.t().reshape(co, cm, 1, 1).contiguous()
    pad = (kw["RS"] - 1) // 2

    def body():
        b = torch.relu(F.conv2d(a, k1))
        c = torch.relu(F.conv2d(b, kd, padding=pad, groups=cm))
        e = F.conv2d(c, k2)
        return e + a if kw["residual"] else e
    return body, 6 if kw["residual"] else 5


def _library_gru(pool, params, kw):
    """The fp32 GRU cell as PyTorch calls: ``addmm`` and ``mm`` for the
    gate pre-activations, then ``gru_update``'s 15 elementwise calls."""
    from repro_torch.core.vpool import fetch_rows
    from repro_torch.quant.requant import gru_update

    w, u, b = params
    d_h = kw["d_h"]
    x = fetch_rows(pool, kw["in_ptr"], 1, kw["d_in"]).contiguous()
    h = fetch_rows(pool, kw["state_ptr"], 1, d_h).contiguous()
    return (lambda: gru_update(torch.addmm(b, x, w), torch.mm(h, u), h,
                               d_h)), 17


def _library_mlp(pool, params, kw):
    """The fused MLP as PyTorch calls on the gathered rows: ``mm`` (two
    when gated), the activation (and the gate's product), ``mm`` and the
    residual ``add``; returns the function and its number of calls."""
    from repro_torch.core.program import resolve_activation
    from repro_torch.core.vpool import fetch_rows

    wg, wu, wd = params
    x = fetch_rows(pool, kw["ptr"], kw["m_rows"], kw["d_model"]).contiguous()
    act = resolve_activation(kw["activation"])
    gated, residual = kw["gated"], kw["residual"]

    def body():
        up = torch.mm(x, wu)
        h = act(torch.mm(x, wg)) * up if gated else act(up)
        y = torch.mm(h, wd)
        return y + x if residual else y
    return body, (6 if gated else 4) - (not residual)


def library_call(kernel: str, pool, params, kw):
    """PyTorch library calls (cuBLAS, cuDNN or a reduction) that compute
    what fp32 ``kernel`` computes on the gathered tensors, as a function
    of no arguments, and the number of calls in it: one, but for the
    fused bottleneck, the GRU cell and the fused MLP, which no single
    call computes.
    None for an int8 kernel or a resampling pw.  The gather from the
    ring (a stream's shifted window too), and a conv's zero padding, are
    left out of the calls."""
    import torch.nn.functional as F

    from repro_torch.core.program import resolve_activation
    from repro_torch.core.rowsched import conv_k2d_pad, conv_k2d_pad_w
    from repro_torch.core.vpool import fetch_rows, fetch_segments

    if kernel.endswith("_q") or kw.get("resample"):
        return None
    if kernel == "ring_inverted_bottleneck":
        return _library_ib(pool, params, kw)
    if kernel == "ring_gru_cell":
        return _library_gru(pool, params, kw)
    if kernel == "ring_fused_mlp":
        return _library_mlp(pool, params, kw)
    if kernel == "ring_elementwise":
        segs = fetch_segments(pool, kw["ptr"],
                              kw["m_rows"] * _segs(kw["d"])).contiguous()
        fn = resolve_activation(kw["fn"])
        return (lambda: fn(segs)), 1
    act = resolve_activation(kw.get("activation"))
    if kernel == "ring_avgpool":
        img = fetch_rows(pool, kw["in_ptr"], kw["h"] * kw["w"],
                         kw["c"]).contiguous()
        return (lambda: img.mean(dim=0)), 1
    if kernel == "ring_add":
        x, r = (fetch_rows(pool, kw[p], kw["rows"], kw["d"]).contiguous()
                for p in ("in_ptr", "aux_ptr"))
        return (lambda: act(torch.add(x, r))), 1
    w, b = params
    if kernel == "ring_gemm":
        x = fetch_rows(pool, kw["in_ptr"], kw["m_rows"],
                       kw["d_in"]).contiguous()
        return (lambda: act(torch.addmm(b, x, w))), 1
    if kernel == "ring_conv_stream":
        c_in, hop, w_in = kw["c_in"], kw["hop"], kw["w_in"]
        keep = fetch_rows(pool, kw["state_ptr"] + hop * w_in * _segs(c_in),
                          (kw["h_win"] - hop) * w_in, c_in)
        frame = fetch_rows(pool, kw["in_ptr"], hop * w_in, c_in)
        img = torch.cat([keep, frame]).reshape(1, kw["h_win"], w_in, c_in) \
            .permute(0, 3, 1, 2)
        kw = dict(kw, h_in=kw["h_win"])
        dw = False
    else:
        dw = kernel == "ring_conv_dw"
        c_in = kw["c"] if dw else kw["c_in"]
        img = fetch_rows(pool, kw["in_ptr"], kw["h_in"] * kw["w_in"], c_in)
        img = img.reshape(1, kw["h_in"], kw["w_in"], c_in) \
            .permute(0, 3, 1, 2)
    if kernel == "ring_conv_pw":
        wt = w.t().reshape(kw["c_out"], c_in, 1, 1).contiguous()
        k, pv, ph = 1, 0, 0
    else:
        k = kw["rs"] if dw else kw["k"]
        wt = (w.permute(2, 0, 1)[:, None] if dw else
              w.permute(3, 2, 0, 1)).contiguous()
        pv = conv_k2d_pad(k, kw["padding"])
        ph = conv_k2d_pad_w(k, kw["padding"])
    s = kw["stride"]
    bottom = (kw["h_out"] - 1) * s + k - pv - kw["h_in"]
    right = (kw["w_out"] - 1) * s + k - ph - kw["w_in"]
    x = F.pad(img, (ph, right, pv, bottom)).contiguous()
    groups = c_in if dw else 1
    return (lambda: act(F.conv2d(x, wt, b, stride=s, groups=groups))), 1


def _work_kw(kernel: str, kw: dict, params) -> dict:
    """A call's kwargs and what its bound needs beyond them: a fused
    MLP's ``d_ff``, from W_up."""
    if kernel == "ring_fused_mlp":
        return dict(kw, d_ff=params[1].shape[1])
    return kw


#: Kernels whose phase-4 row also lists each op's device and library
#: time (``per_op``), not only the plan's mean.
PER_OP_KERNELS = ("ring_gemm_q", "ring_gemm", "ring_conv_k2d_q",
                  "ring_conv_pw_q", "ring_conv_dw_q", "ring_add_q",
                  "ring_conv_stream_q", "ring_avgpool_q", "ring_gru_cell_q",
                  "ring_avgpool", "ring_gru_cell")


def time_cases(cases) -> dict[str, dict]:
    """Per kernel over ``cases`` (one per op of a plan): the mean device
    time per launch, host time with the launch, plain-version time and
    bound (and, for ``PER_OP_KERNELS``, each op's device and library
    time)."""
    from repro_torch.kernels import KERNELS, PLAIN
    from repro_torch.kernels.cases import case_inputs

    out: dict[str, dict] = {}
    for name in KERNELS:
        ms, plain_ms, host_ms, bounds, lib_ms = [], [], [], [], []
        lib_calls, per_op = None, {}
        for case in (c for c in cases if c.kernel == name):
            pool, params = case_inputs(case, seed=0)
            pool, params = torch.from_numpy(pool).cuda(), _cuda(params)
            kern, plain = KERNELS[name], PLAIN[name]
            lib = library_call(name, pool, params, case.kwargs)
            if lib is not None:
                lib_ms.append(_held_ms(lib[0], 50))
                lib_calls = lib[1]
            host_ms.append(_host_ms(
                lambda: kern(pool, *params, **case.kwargs), 20))
            ms.append(_held_ms(lambda: kern(pool, *params, **case.kwargs),
                               50))
            plain_ms.append(_event_ms(
                lambda: plain(pool, *params, **case.kwargs), 5))
            bounds.append(bound(name, _work_kw(name, case.kwargs, params)))
            per_op[case.name] = [ms[-1], lib_ms[-1] if lib else None]
        if ms:
            out[name] = {"ms": statistics.mean(ms),
                         "plain_ms": statistics.mean(plain_ms),
                         "host_ms": statistics.mean(host_ms),
                         "bound_ms": statistics.mean(b for b, _ in bounds),
                         "bound_by": bounds[0][1], "ops": len(ms),
                         "library_ms": (statistics.mean(lib_ms)
                                        if len(lib_ms) == len(ms)
                                        else None),
                         "library_calls": lib_calls}
            if name in PER_OP_KERNELS:
                out[name]["per_op"] = per_op
    return out


def time_add_modes(cases) -> dict[str, dict]:
    """``ring_add_q`` on each int8 add of ``cases`` in each mode it may
    take: the barrier-free row map where ``quantized.add_needs_barrier``
    allows it, and the read-first cooperative launch (forced where the map
    would do); each launch bitwise the plain version, then timed, ms a
    launch (held-stream CUDA events), by case and mode."""
    from repro_torch.kernels import quantized
    from repro_torch.kernels.cases import case_inputs

    need, out = quantized.add_needs_barrier, {}
    for case in (c for c in cases if c.kernel == "ring_add_q"):
        kw, n = case.kwargs, case.n_seg
        pool, _ = case_inputs(case, seed=0)
        want = torch.from_numpy(pool).cuda()
        quantized.ring_add_q_plain(want, **kw)
        modes = [True] if need(n, kw["rows"], kw["d"], kw["in_ptr"] % n,
                               kw["aux_ptr"] % n, kw["out_ptr"] % n) \
            else [False, True]
        row = {}
        for barrier in modes:
            quantized.add_needs_barrier = lambda *a, b=barrier: b
            try:
                got = torch.from_numpy(pool).cuda()
                quantized.ring_add_q(got, **kw)
                torch.cuda.synchronize()
                if quantized.ring_add_q.barrier is not barrier \
                        or not torch.equal(got, want):
                    raise SystemExit(f"{case.name}: ring_add_q with barrier="
                                     f"{barrier} differs from its plain "
                                     "version")
                row["read_first" if barrier else "map"] = _held_ms(
                    lambda: quantized.ring_add_q(got, **kw), 50)
            finally:
                quantized.add_needs_barrier = need
        out[case.name] = row
    say("  ring_add_q by mode, bitwise the plain version in each (us a "
        "launch, device): "
        + "; ".join(f"{name} " + ", ".join(f"{m} {v * 1e3:.2f}"
                                           for m, v in row.items())
                    for name, row in out.items()))
    return out


def time_gemm_modes(cases) -> dict[str, dict]:
    """``ring_gemm_q`` on each int8 FC of ``cases`` in both modes of
    ``quantized.gemm_q_tiling``: one CTA in an ordinary launch (where its
    shared memory fits) and the column tiles under a grid barrier in a
    cooperative launch (its barrier even over one CTA); each launch
    bitwise the plain version, then timed, ms a launch (held-stream CUDA
    events), by case and mode, beside the mode the rule gives."""
    from repro_torch.kernels import quantized
    from repro_torch.kernels._launch import MAX_SMEM
    from repro_torch.kernels.cases import case_inputs

    tiling, out = quantized.gemm_q_tiling, {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for case in (c for c in cases if c.kernel == "ring_gemm_q"):
        kw = case.kwargs
        shape = (kw["m_rows"], kw["d_in"], kw["d_out"])
        pool, params = case_inputs(case, seed=0)
        params = _cuda(params)
        want = torch.from_numpy(pool).cuda()
        quantized.ring_gemm_q_plain(want, *params, **kw)
        row = {"rule": "grid" if tiling(*shape, n_sm).barrier else "one"}
        for mode, one in (("one", True), ("grid", False)):
            if one and quantized.GemmQTiling(*shape, shape[0], shape[2],
                                             False).smem > MAX_SMEM:
                continue
            quantized.gemm_q_tiling = \
                lambda m, i, o, n, one=one: tiling(m, i, o, n, one)
            try:
                got = torch.from_numpy(pool).cuda()
                quantized.ring_gemm_q(got, *params, **kw)
                torch.cuda.synchronize()
                if quantized.ring_gemm_q.barrier is one \
                        or not torch.equal(got, want):
                    raise SystemExit(f"{case.name}: ring_gemm_q in mode "
                                     f"{mode} differs from its plain "
                                     "version")
                row[mode] = _held_ms(
                    lambda: quantized.ring_gemm_q(got, *params, **kw), 50)
            finally:
                quantized.gemm_q_tiling = tiling
        out[case.name] = row
    say("  ring_gemm_q by mode, bitwise the plain version in each (us a "
        "launch, device; the rule's mode first): "
        + "; ".join(f"{name} ({row['rule']}) "
                    + ", ".join(f"{m} {v * 1e3:.2f}"
                                for m, v in row.items() if m != "rule")
                    for name, row in out.items()))
    return out


def time_gru_modes(cases, kernel: str) -> dict[str, dict]:
    """``kernel`` (``ring_gru_cell_q`` or ``ring_gru_cell``) on each GRU
    cell of ``cases`` in both modes of its tiling (``stream.gru_q_tiling``,
    ``stream.gru_tiling``): one CTA in an ordinary launch (where its
    shared memory fits) and the channel tiles under a grid barrier in a
    cooperative launch; each launch held to the plain version (int8
    bitwise, fp32 by ``cases.compare_f32``), then timed, ms a launch
    (held-stream CUDA events), by case and mode, beside the mode the rule
    gives."""
    from repro_torch.kernels import stream
    from repro_torch.kernels._launch import MAX_SMEM
    from repro_torch.kernels.cases import (case_inputs, compare_f32,
                                           is_f32, live_lanes,
                                           output_regions)

    f32 = is_f32(kernel)
    name = "gru_tiling" if f32 else "gru_q_tiling"
    tiling = getattr(stream, name)
    cls = stream.GruTiling if f32 else stream.GruQTiling
    wrapper, plain = getattr(stream, kernel), getattr(stream,
                                                      f"{kernel}_plain")
    out = {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for case in (c for c in cases if c.kernel == kernel):
        kw = case.kwargs
        shape = (kw["d_in"], kw["d_h"])
        pool, params = case_inputs(case, seed=0)
        params = _cuda(params)
        want = torch.from_numpy(pool).cuda()
        plain(want, *params, **kw)
        live = live_lanes(case.n_seg, output_regions(kernel, kw))
        rule = tiling(*shape, n_sm)
        row = {"rule": "grid" if rule.barrier else "one"}
        for mode, one in (("one", True), ("grid", False)):
            if one and cls(*shape, shape[1], False).smem > MAX_SMEM:
                continue
            setattr(stream, name,
                    lambda i, h, n, one=one: tiling(i, h, n, one))
            try:
                got = torch.from_numpy(pool).cuda()
                wrapper(got, *params, **kw)
                torch.cuda.synchronize()
                held = (compare_f32(got.cpu().numpy(), want.cpu().numpy(),
                                    live)[1] is None if f32
                        else torch.equal(got, want))
                if wrapper.barrier is one or not held:
                    raise SystemExit(f"{case.name}: {kernel} in mode "
                                     f"{mode} differs from its plain "
                                     "version")
                row[mode] = _held_ms(lambda: wrapper(got, *params, **kw),
                                     50)
                if not one:
                    row["grid_ctas"] = tiling(*shape, n_sm, False).ctas
            finally:
                setattr(stream, name, tiling)
        out[case.name] = row
    say(f"  {kernel} by mode, "
        + ("within the tolerance of" if f32 else "bitwise")
        + " the plain version in each (us a launch, device; the rule's "
        "mode first): "
        + "; ".join(f"{name} ({row['rule']}) "
                    + ", ".join(f"{m} {v * 1e3:.2f}" for m, v in row.items()
                                if m in ("one", "grid"))
                    + f" ({row['grid_ctas']} CTAs)"
                    for name, row in out.items()))
    return out


#: The batch whose per-inference latency phase 4 reports beside batch 1.
BATCH = 8
#: Tilings of a fused-MLP layer timed beside the one ``mlp_tiling`` picks:
#: (rows per thread, d_ff columns per sub-tile).
MLP_TILINGS = ((3, 128), (5, 128), (5, 256), (8, 256))


def time_mlp_tilings(case) -> dict[str, float]:
    """``ring_fused_mlp``'s device time per launch on ``case`` under each
    of ``MLP_TILINGS`` and under the tiling ``fused_mlp.mlp_tiling``
    picks, by ``"<rows>x<sub-tile>"``; the first key is the pick."""
    from repro_torch.kernels import fused_mlp
    from repro_torch.kernels.cases import case_inputs

    pool, params = case_inputs(case, seed=0)
    pool, params = torch.from_numpy(pool).cuda(), _cuda(params)
    kw = case.kwargs
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    pick = fused_mlp.mlp_tiling(kw["m_rows"], kw["d_model"],
                                params[1].shape[1], kw["ff_tile"],
                                kw["gated"], n_sm)
    tilings = [pick] + [dataclasses.replace(
        pick, tm=tm, sub=sub, splits=-(-kw["ff_tile"] // sub))
        for tm, sub in MLP_TILINGS if (tm, sub) != (pick.tm, pick.sub)]
    out = {}
    choose = fused_mlp.mlp_tiling
    try:
        for t in tilings:
            fused_mlp.mlp_tiling = lambda *a, t=t, **k: t
            out[f"{t.rows}x{t.sub}"] = _held_ms(
                lambda: fused_mlp.ring_fused_mlp(pool, *params, **kw), 50)
    finally:
        fused_mlp.mlp_tiling = choose
    say(f"  ring_fused_mlp on {case.name} by tiling (rows per CTA x d_ff "
        f"columns per sub-tile: us a launch; the first is mlp_tiling's "
        f"pick, {pick.ctas} CTAs): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in out.items()))
    return out


def phase_timing(served, streamed, cases, counts, errs, goldens):
    """Times every path and its kernels; returns the per-kernel rows of
    the ``{"kernels": [...]}`` line and the per-path latency and busy
    share."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels._build import source_of

    say("phase 4: timing (library calls: one PyTorch call per op on the "
        "gathered, zero-padded tensors, a short sequence for the fused "
        "bottleneck, the fp32 GRU cell and the fused MLP; TF32 off)")
    by_path = {}
    for label, cn, drive, per in served + streamed:
        t = time_cases(cases[label])
        busy, call_us, prof_ms, prof_parts = _device_busy(drive)
        lat = _host_ms(drive, 30)
        busy_txt = "not measured" if busy is None else f"{busy:.4f}"
        say(f"  {label}: {lat:.4f} ms per {per} (host clock, ending in "
            f"synchronize); device busy {busy_txt} of {call_us:.1f} us per "
            f"{per} (profiler)")
        if per == "inference":
            x = torch.from_numpy(goldens[label]["x"]).cuda()
            x = x[torch.arange(BATCH) % len(x)]
            b8 = _host_ms(lambda: cn.run(x), 10) / len(x)
            say(f"  {label}: {b8:.4f} ms per inference at batch {len(x)}")
        for name, row in t.items():
            row["profiler_ms"] = prof_ms.get(name)
            if name in prof_parts:
                row["profiler_ms_parts"] = prof_parts[name]
            row["launches"] = counts[label][name]
            lib = ("" if row["library_ms"] is None else
                   f", library {row['library_ms'] * 1e3:.2f} us in "
                   f"{row['library_calls']} call(s)")
            say(f"    {name:18s} {row['ms'] * 1e3:9.2f} us/launch (device, "
                f"mean of {row['ops']} ops), {row['host_ms'] * 1e3:8.2f} us "
                f"with launch (host), plain {row['plain_ms'] * 1e3:9.2f} "
                f"us, bound {row['bound_ms'] * 1e3:.4f} us "
                f"({row['bound_by']}), {row['launches']} launches{lib}")
            for op, (op_ms, op_lib) in row.get("per_op", {}).items():
                say(f"      {op}: {op_ms * 1e3:.2f} us/launch"
                    + ("" if op_lib is None else
                       f", library {op_lib * 1e3:.2f} us"))
            if name in prof_parts:
                say(f"      on the path (profiler): "
                    + " + ".join(f"{sym} {ms * 1e3:.2f}" for sym, ms in
                                 zip(KERNEL_SYMBOLS[name], prof_parts[name]))
                    + " us a launch")
        by_path[label] = {"latency_ms": lat, "device_busy": busy,
                          "call_us": call_us,
                          "kernels": t}
    rows = []
    for name in KERNELS:
        per = {p: v["kernels"][name] for p, v in by_path.items()
               if name in v["kernels"]}
        if not per:   # not a ring-plan kernel (the decode attention)
            continue
        weight = {p: r["ops"] for p, r in per.items()}
        n = sum(weight.values())

        def avg(key):
            if any(r[key] is None for r in per.values()):
                return None
            return sum(r[key] * weight[p] for p, r in per.items()) / n
        rows.append({
            "name": name, "route": "cuda",
            "source": f"{CSRC}/{source_of(name)}.cu",
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in counts.values()),
            "max_abs_err": errs[name], "ms": avg("ms"),
            "plain_ms": avg("plain_ms"), "bound_ms": avg("bound_ms"),
            "bound_by": next(iter(per.values()))["bound_by"],
            "library_ms": avg("library_ms"),
            "library_calls": next(iter(per.values()))["library_calls"],
            "host_ms": avg("host_ms"), "by_path": per})
    return rows, {p: {k: v for k, v in d.items() if k != "kernels"}
                  for p, d in by_path.items()}

# ---------------------------------------------------------------------------
# The decode attention and the gemma3-1b serve path.
# ---------------------------------------------------------------------------

def _decode_call(case):
    """A decode case's inputs on the card, in its dtype."""
    from repro_torch.kernels.cases import decode_inputs

    q, k, v, seq = decode_inputs(case)
    dt = getattr(torch, case.dtype)
    tq, tk, tv = (torch.from_numpy(a).to(DEVICE_TYPE, dt) for a in (q, k, v))
    if not isinstance(seq, int):
        seq = torch.from_numpy(seq).to(DEVICE_TYPE)
    return tq, tk, tv, seq


def phase_decode_parity() -> float:
    """``ring_decode_attention`` against its plain version on the card on
    every decode case, and with ``return_lse`` on the slice cases (a
    rank's run of gemma3-1b's global cache or whisper-tiny's self caches
    split on ``kv_seq``, at batch 4 and 1: part filled, full, empty);
    returns the max |difference|."""
    from repro_torch.kernels.cases import (DECODE_CASES, LM_DECODE_CASES,
                                           SLICE_DECODE_CASES, compare_decode,
                                           compare_lse)
    from repro_torch.kernels.ring_decode import (
        decode_splits, ring_decode_attention, ring_decode_attention_plain)

    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits = []
    cases = DECODE_CASES + LM_DECODE_CASES
    for case in cases:
        sp = decode_splits(case.batch or 1, case.kv_heads, case.window, n_sm)
        splits.append(f"{case.name} {sp.splits} splits of {sp.split_len} "
                      f"slots, {sp.ctas} CTAs")
        args = _decode_call(case)
        want = ring_decode_attention_plain(*args, **case.kwargs)
        got = ring_decode_attention(*args, **case.kwargs)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise SystemExit(f"{case.name}: the kernel gives {got.dtype} "
                             f"{tuple(got.shape)}")
        err, bad = compare_decode(got.float().cpu().numpy(),
                                  want.float().cpu().numpy(), case.dtype)
        if bad:
            raise SystemExit(f"{case.name}: ring_decode_attention differs "
                             f"from its plain version, {bad}")
        worst[case.dtype] = max(worst[case.dtype], err)
    lse_worst = 0.0
    for case in SLICE_DECODE_CASES:
        args = _decode_call(case)
        want, want_lse = ring_decode_attention_plain(*args, **case.kwargs,
                                                     return_lse=True)
        got, lse = ring_decode_attention(*args, **case.kwargs,
                                         return_lse=True)
        torch.cuda.synchronize()
        if torch.isnan(got).any() or torch.isnan(lse).any():
            raise SystemExit(f"{case.name}: return_lse gives NaN")
        err, bad = compare_decode(got.float().cpu().numpy(),
                                  want.float().cpu().numpy(), case.dtype)
        lerr, lbad = compare_lse(lse.cpu().numpy(), want_lse.cpu().numpy())
        if bad or lbad:
            raise SystemExit(f"{case.name}: ring_decode_attention(..., "
                             f"return_lse=True) differs from its plain "
                             f"version: out {bad}, lse {lbad}")
        worst[case.dtype] = max(worst[case.dtype], err)
        lse_worst = max(lse_worst, lerr)
    say(f"  ring_decode_attention: {len(cases)} calls within the "
        f"tolerance of its plain version (fp32 2e-5, bf16 one ulp of the "
        f"output's scale), and {len(SLICE_DECODE_CASES)} with return_lse "
        f"on the kv_seq slices (gemma3-1b's global cache: 512 and 256 "
        f"slots; whisper-tiny's self caches: 128 slots; batch 4 and 1; "
        f"part filled, full, empty, mixed rows; lse within 2e-5, -inf on "
        f"the empty rows, no NaN); max |difference| fp32 "
        f"{worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}, lse "
        f"{lse_worst:.3g}; splits on {n_sm} SMs:")
    for line in splits:
        say(f"    {line}")
    return max(worst.values())


def _draw(name: str):
    """``(lm_params(cfg, SEED), seconds)`` of a config, on the host."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.cases import lm_params

    t0 = time.perf_counter()
    tree = lm_params(get_config(name), SEED)
    return tree, time.perf_counter() - t0


def start_lm_draws(names) -> dict:
    """Start each LM's host draw (``lm_params(cfg, SEED)``) on a thread
    of its own, so that the draws run beside the phases before their
    paths (numpy's generators release the GIL while they fill an array);
    returns each name's future of ``(tree, seconds)``.  The threads end
    with their draws."""
    from concurrent.futures import ThreadPoolExecutor

    import repro_torch.kernels.cases  # noqa: F401  (imported here, once)

    pool = ThreadPoolExecutor(max_workers=len(names),
                              thread_name_prefix="lm-draw")
    futures = {name: pool.submit(_draw, name) for name in names}
    pool.shutdown(wait=False)
    return futures


def lm_setup(name: str = LM, draws: dict | None = None,
             keep_tree: bool = False):
    """A config's ``lm_params(cfg, SEED)`` on the card (matmul weights
    bf16, embeddings fp32), taken from ``draws`` (:func:`start_lm_draws`)
    or drawn here, with its parameter count, its bytes on the card, the
    seconds of its host draw and the seconds this thread waited for it
    printed; with ``keep_tree``, also the host draw itself (the fp32
    tree that training starts from)."""
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_reference

    cfg = get_config(name)
    t0 = time.perf_counter()
    threaded = draws is not None
    tree, draw_s = draws.pop(name).result() if threaded else _draw(name)
    t1 = time.perf_counter()
    params = params_from_reference(cfg, tree, DEVICE_TYPE)
    if not keep_tree:
        del tree
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    where = f"on a host thread beside the earlier phases (waited " \
        f"{t1 - t0:.1f} s for it)" if threaded else "here"
    say(f"  {name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}: {n:,} parameters ({nbytes / 1e9:.3f} GB on the "
        f"card) drawn by lm_params in {draw_s:.1f} s {where}, moved in "
        f"{time.perf_counter() - t1:.1f} s")
    return (cfg, params, tree) if keep_tree else (cfg, params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass(frozen=True)
class LMPath:
    """An LM served at full width and depth in phase 3 and timed in
    phase 4: its seeded prompts' lengths (left-padded to the longest),
    the decode cache length, the tokens generated, and the
    ``ring_decode_attention`` launches of one decode step (one a
    self-attention layer and one a cross layer's memory, for the whole
    batch)."""

    name: str
    prompt_lens: tuple
    cache_len: int
    per_step: int
    max_new: int = LM_MAX_NEW


#: gemma3-1b (its 600-token prompt wraps the 512-slot local rings), then
#: an LM of each other block kind, resident one at a time:
#: recurrentgemma-2b (rec, rec, local: 8 local layers, a 2,048-slot ring
#: the 2,100-token prompt wraps in prefill, 10 q heads on one KV head of
#: 256), granite-moe-1b-a400m (24 full layers, 32 experts top 8: the
#: prefill's 2,400 tokens have 750 slots an expert, so choices drop),
#: mamba2-780m (48 ssm layers, no attention: SSD over 3 chunks of 256 with
#: padding) and whisper-tiny (4 encoder layers over 1,500 seeded frames,
#: 4 cross layers: 4 self and 4 memory launches a step).
LM_PATHS = (
    LMPath(LM, LM_PROMPT_LENS, LM_CACHE_LEN, 26),
    LMPath("recurrentgemma-2b", (8, 64, 600, 2100), 2176, 8),
    LMPath("granite-moe-1b-a400m", (8, 64, 500, 600), 1024, 24),
    LMPath("mamba2-780m", (8, 64, 500, 600), 1024, 0),
    LMPath("whisper-tiny", (8, 64, 200, 400), 512, 8),
)


def lm_prompts_of_path(cfg, prompt_lens=LM_PROMPT_LENS):
    """The serve path's seeded prompts (``prompt_lens`` tokens) and the
    left-padded batch the engine makes of them."""
    rng = np.random.default_rng([SEED, 2])
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in prompt_lens]
    L = max(prompt_lens)
    padded = torch.tensor([[0] * (L - len(p)) + p for p in prompts],
                          device=DEVICE_TYPE)
    return prompts, padded


def lm_memory_of_path(cfg, batch: int):
    """The seeded memory (``cases.lm_memory``) of a config with cross
    blocks on the card, else None."""
    from repro_torch.kernels.cases import lm_memory

    mem = lm_memory(cfg, SEED, batch)
    return None if mem is None else torch.from_numpy(mem).to(DEVICE_TYPE)


def forced_steps(model, params, padded, out, path: LMPath, memory=None,
                 rules=None) -> tuple[list, list]:
    """One path teacher-forced on the generated tokens ``out``: each
    step's logits over the whole vocabulary (gathered over a ``model``
    axis) as numpy, and its routing codes (``cases.route_codes``; None
    without MoE), the prefill's first."""
    from repro_torch.kernels.cases import route_codes
    from repro_torch.models.transformer import vocab_logits
    from repro_torch.parallel.sharding import no_sharding

    rules = rules or no_sharding()
    steps, codes, routes = [], [], []
    logits, caches, cur = model.prefill(params, padded,
                                        cache_len=path.cache_len,
                                        memory=memory, routes=routes,
                                        rules=rules)
    for t in range(path.max_new + 1):
        steps.append(vocab_logits(logits, rules).float().cpu().numpy())
        codes.append(route_codes(routes) if routes else None)
        routes.clear()
        if t == path.max_new:
            break
        tok = torch.tensor([row[t] for row in out], device=DEVICE_TYPE)
        logits, caches, cur = model.decode_step(params, caches, tok, cur,
                                                routes=routes, rules=rules)
    return steps, codes


def hold_forced(name: str, cfg, kern, plain, out, max_new: int,
                what: str) -> None:
    """Phase 3's check of two teacher-forced runs (:func:`forced_steps`
    of the kernel path and of the plain path): every step's logits within
    the bf16 tolerance of the plain path's (a row of an MoE config that
    misses let pass only from the step on where the two routings really
    sent one of its tokens to other experts) and their argmax the
    generated tokens ``out``."""
    from repro_torch.kernels.cases import logits_close, routed_apart

    (steps, codes), (ref_steps, ref_codes) = kern, plain
    B = len(out)
    worst, scale, passed = 0.0, 0.0, []
    apart = np.full(B, max_new + 1)
    for t in range(max_new + 1):
        got, ref = steps[t], ref_steps[t]
        if codes[t] is not None:
            rows = routed_apart(codes[t], ref_codes[t]).any(1)
            apart[rows] = np.minimum(apart[rows], t)
        if not np.isfinite(got).all() or got.shape != (B, cfg.vocab):
            raise SystemExit(f"{name}: step {t} logits {got.shape} are "
                             "not finite")
        s = float(np.abs(ref).max())
        for b in range(B):
            err, ok = logits_close(got[b], ref[b], s)
            if not ok and apart[b] > t:
                raise SystemExit(
                    f"{name}: step {t} row {b} logits differ from the "
                    f"plain path's by {err:.3g} (max |logit| {s:.3g})")
            if not ok:
                passed.append((t, b))
            elif apart[b] > t:
                worst = max(worst, err)
        scale = max(scale, s)
        tok = [row[t] for row in out] if t < max_new else None
        if tok is not None and [int(i) for i in got.argmax(-1)] != tok:
            raise SystemExit(f"{name}: generate's tokens {t} {tok} are "
                             "not the argmax of the same path's logits")
    gone = {b: int(apart[b]) for b in range(B) if apart[b] <= max_new}
    say(f"  {name}: {what}, {max_new} new: the prefill and every decode "
        f"step's logits within rtol 2e-2, atol 2e-2 * max|logits| of the "
        f"plain path's (max |difference| {worst:.4g}, max |logit| "
        f"{scale:.4g})"
        + (f"; the two paths routed apart in (row: from step) "
           f"{gone or 'none'}, misses let pass at (step, row) "
           f"{passed or 'none'}" if cfg.n_experts else ""))


def golden_rows(model, params, golden, rules=None) -> tuple[dict, list]:
    """``cases.hold_lm_golden`` of the model, and its greedy tokens for
    each of the golden's prompts at batch 1."""
    from repro_torch.kernels.cases import hold_lm_golden
    from repro_torch.serve import ServingEngine

    held = hold_lm_golden(model, params, golden, rules)
    mem1 = lm_memory_of_path(model.cfg, 1)
    rows = [ServingEngine(model, params, rules=rules,
                          cache_len=int(golden["cache_len"])).generate(
        [[int(t) for t in golden["prompts"][i, :n]]],
        max_new=golden["tokens"].shape[1], memory=mem1)[0]
        for i, n in enumerate(golden["prompt_lens"])]
    return held, rows


def hold_golden(name: str, cfg, held: dict, rows: list, golden) -> None:
    """The reference's full-width golden at batch 1 (:func:`golden_rows`):
    the teacher-forced logits within the tolerance, and each greedy row
    the golden's tokens up to a near tie that flipped (an MoE prompt's
    misses let pass only where its routing went apart from the
    reference's)."""
    from repro_torch.kernels.cases import near_tie

    if not held["ok"]:
        raise SystemExit(f"{name}: the port differs from the full-width "
                         f"golden: {held}")
    for i, row in enumerate(rows):
        if any(p == i for p, _ in held["routed_apart"]):
            continue
        for t, (a, b) in enumerate(zip(row, golden["tokens"][i])):
            if a == b:
                continue
            if not near_tie(golden["top_logits"][i, t, :2],
                            float(golden["absmax"][i, t])):
                raise SystemExit(f"{name}: golden prompt {i} token {t} is "
                                 f"{a}, not {b}")
            break   # after a flipped near tie the contexts differ
    say(f"  {name}: the reference's full-width golden held at batch 1 "
        f"(teacher-forced top-64 logits within the tolerance, max "
        f"|difference| {held['max_err']:.4g}; greedy tokens "
        f"{held['tokens']}, near ties flipped at {held['flips'] or 'none'}"
        + (f", misses let pass where the routing went apart from the "
           f"reference's, from (prompt, step) "
           f"{held['routed_apart'] or 'none'}" if cfg.n_experts else "")
        + ")")


def path_lm(cfg, params, golden, path: LMPath = LM_PATHS[0],
            rules=None) -> dict[str, int]:
    """An LM's ``ServingEngine.generate`` on the card: exactly
    ``path.per_step`` ``ring_decode_attention`` launches per decode step
    and no other kernel; logits teacher-forced on its tokens within the
    bf16 tolerance of the plain path's at every step (:func:`hold_forced`);
    the golden's tokens and top-64 logits at batch 1
    (:func:`hold_golden`; no golden where ``golden`` is None).  With
    ``rules`` (a mesh's) every call of both paths runs on the mesh."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity as moe_capacity
    from repro_torch.serve import ServingEngine

    name = path.name
    model, plain = build_model(cfg), build_model(cfg, plain=True)
    prompts, padded = lm_prompts_of_path(cfg, path.prompt_lens)
    B = len(prompts)
    memory = lm_memory_of_path(cfg, B)
    engine = ServingEngine(model, params, rules=rules,
                           cache_len=path.cache_len)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=path.max_new, memory=memory)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {"ring_decode_attention": path.per_step * path.max_new} \
        if path.per_step else {}
    if {k: n for k, n in counts.items() if n} != want:
        raise SystemExit(f"{name}: launches {counts} are not {want} "
                         f"({path.per_step} per decode step)")
    say(f"  {name} generate launches: {want or 'none'} ({path.per_step} "
        f"per decode step at batch {B}; {gen_s:.2f} s)")
    if [len(o) for o in out] != [path.max_new] * B or not all(
            0 <= t < cfg.vocab for o in out for t in o):
        raise SystemExit(f"{name}: generate gave {out}")

    kern = forced_steps(model, params, padded, out, path, memory, rules)
    if cfg.n_experts:
        drops = [int((c < 0).sum()) for c in kern[1][0]]
        T = padded.numel()
        say(f"  {name} prefill: T = {T} tokens, {moe_capacity(cfg, T)} "
            f"slots an expert; choices dropped of {T * cfg.top_k} by layer "
            f"{drops} ({sum(drops)} in all)")
    hold_forced(name, cfg, kern, forced_steps(plain, params, padded, out,
                                              path, memory, rules),
                out, path.max_new,
                f"{B} prompts of {list(path.prompt_lens)} tokens")
    if golden is not None:
        hold_golden(name, cfg, *golden_rows(model, params, golden, rules),
                    golden)
    torch.cuda.synchronize()
    return counts


def _decode_bound(B, q_heads, kv_heads, d, valid, elem=2):
    """``(bound_ms, by)`` of one decode-attention launch: q, the valid
    slots' K and V and the output once each; 2 fp32 operations per
    multiply-add of its two products (CUDA cores)."""
    nbytes = elem * (2 * B * q_heads * d + 2 * B * valid * kv_heads * d)
    ops = 4 * B * q_heads * valid * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def time_decode_kernel(cfg, seq: int, counts, err) -> dict:
    """``ring_decode_attention`` at the serve path's two shapes (batch 4,
    bf16): a local ring of ``cfg.window`` slots and the global cache of
    ``LM_CACHE_LEN``, ``seq`` tokens so far; the kernel's time, its plain
    version's, one ``F.scaled_dot_product_attention`` call on the same
    tensors with the validity mask, and the bound.  The row's numbers are
    the means over the path's launches (22 local, 4 global)."""
    import torch.nn.functional as F

    from repro_torch.kernels.ring_decode import (
        ring_decode_attention, ring_decode_attention_plain)
    from repro_torch.models.transformer import layer_kinds

    B, H, KV, d = len(LM_PROMPT_LENS), cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    kinds = layer_kinds(cfg)
    g = torch.Generator(device=DEVICE_TYPE).manual_seed(SEED)
    shapes = {}
    for kind, S in (("local", cfg.window), ("global", LM_CACHE_LEN)):
        q = torch.randn((B, H, d), generator=g, device=DEVICE_TYPE) \
            .to(torch.bfloat16)
        k, v = (torch.randn((B, S, KV, d), generator=g, device=DEVICE_TYPE)
                .to(torch.bfloat16) for _ in range(2))
        slot = torch.arange(S, device=DEVICE_TYPE)
        mask = ((slot < seq) | (seq >= S))[None, None, None, :] \
            .expand(B, 1, 1, S)
        qs, ks, vs = q[:, :, None], k.permute(0, 2, 1, 3), \
            v.permute(0, 2, 1, 3)
        kw = dict(window=S, block=128)
        ms = _held_ms(lambda: ring_decode_attention(q, k, v, seq, **kw),
                      200)
        plain_ms = _event_ms(
            lambda: ring_decode_attention_plain(q, k, v, seq, **kw), 20)
        lib_ms = _held_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), 200)
        valid = S if seq >= S else min(seq, S)
        b_ms, by = _decode_bound(B, H, KV, d, valid)
        shapes[kind] = {"slots": S, "valid": valid, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": by,
                        "per_step": kinds.count(kind)}
        say(f"    ring_decode_attention {kind:6s} ({S} slots, {valid} "
            f"valid, batch {B}, bf16): {ms * 1e3:8.2f} us/launch (device), "
            f"plain {plain_ms * 1e3:9.2f} us, library (SDPA) "
            f"{lib_ms * 1e3:8.2f} us, bound {b_ms * 1e3:.4f} us ({by})")
    n = sum(v["per_step"] for v in shapes.values())

    def avg(key):
        return sum(v[key] * v["per_step"] for v in shapes.values()) / n
    return {"name": "ring_decode_attention", "route": "cuda",
            "source": f"{CSRC}/ring_decode.cu",
            "replaces": REPLACES["ring_decode_attention"],
            "launches": counts["ring_decode_attention"],
            "max_abs_err": err, "ms": avg("ms"), "plain_ms": avg("plain_ms"),
            "bound_ms": avg("bound_ms"), "bound_by": shapes["local"]
            ["bound_by"], "library_ms": avg("library_ms"),
            "library_calls": 1, "by_shape": shapes}


#: bf16 products on the tensor cores (NVIDIA data sheet, dense, 700 W).
BF16_OPS_PER_S = 989e12


def decode_weight_bytes(cfg, params) -> tuple[int, int]:
    """``(bytes, parameters)`` one decode step must read: every decoder
    layer's weights as they lie on the card (of an MoE layer's experts,
    ``top_k`` of ``n_experts``: the router, the shared experts and the
    chosen experts' gate, up and down), the final norm, and the
    (un)embedding the logits read whole; the encoder's weights (run once
    in prefill) and the embedding rows the step gathers are left out."""
    nbytes = params_n = 0
    for layer in params["layers"]:
        for t in _leaves(layer):
            nbytes += t.numel() * t.element_size()
            params_n += t.numel()
        ffn = layer.get("ffn", {})
        if "moe_gate" in ffn:
            skip = 1 - cfg.top_k / cfg.n_experts
            for key in ("moe_gate", "moe_up", "moe_down"):
                t = ffn[key]
                nbytes -= int(t.numel() * t.element_size() * skip)
                params_n -= int(t.numel() * skip)
    for t in _leaves(params["final_ln"]):
        nbytes += t.numel() * t.element_size()
        params_n += t.numel()
    w = params.get("unembed", params["embed"])
    return (nbytes + w.numel() * w.element_size(), params_n + w.numel())


def time_lm(cfg, params, path: LMPath = LM_PATHS[0], rules=None) -> dict:
    """An LM's prefill latency at batch 4 and per-token decode latency at
    batch 1 and 4 (host clock ending in synchronize), each with the
    device-busy share and ring_decode_attention's profiled time per
    launch (torch.profiler), beside their bounds: a decode step's weight
    bytes (:func:`decode_weight_bytes`) at 3.35 TB/s; a prefill's the
    larger of those bytes and 2 x weights' parameters x tokens products
    at the bf16 tensor-core rate (attention's products left out).  With
    ``rules`` (a mesh's) the calls run on the mesh."""
    from repro_torch.models import build_model

    name = path.name
    model = build_model(cfg)
    _, padded = lm_prompts_of_path(cfg, path.prompt_lens)
    memory = lm_memory_of_path(cfg, len(padded))
    nbytes, n_params = decode_weight_bytes(cfg, params)
    step_bound = nbytes / HBM_BYTES_PER_S * 1e3
    tokens = padded.numel()
    pre_bound = max(nbytes / HBM_BYTES_PER_S,
                    2 * n_params * tokens / BF16_OPS_PER_S) * 1e3

    def prefill():
        model.prefill(params, padded, cache_len=path.cache_len,
                      memory=memory, rules=rules)
    prefill_ms = _host_ms(prefill, 3)
    busy, call_us, _, _ = _device_busy(prefill, 1)
    out = {"prefill_ms_batch4": prefill_ms, "prefill_busy_batch4": busy,
           "prefill_bound_ms": pre_bound, "decode_bound_ms": step_bound,
           "decode_weight_bytes": nbytes}
    busy_txt = "not measured" if busy is None else f"{busy:.4f}"
    say(f"  {name} serve: prefill {prefill_ms:.3f} ms at batch "
        f"{len(padded)} x {padded.shape[1]} tokens (host clock, ending in "
        f"synchronize), device busy {busy_txt} of {call_us:.1f} us "
        f"(profiler), bound {pre_bound:.3f} ms")
    for B in (1, len(padded)):
        toks = padded[-B:]
        mem = None if memory is None else memory[-B:]
        logits, caches, cur = model.prefill(params, toks,
                                            cache_len=path.cache_len,
                                            memory=mem, rules=rules)
        tok = logits.argmax(-1)

        def step():   # the same step again: the same work every call
            model.decode_step(params, caches, tok, cur, rules=rules)
        ms = _host_ms(step, 20)
        busy, call_us, prof, _ = _device_busy(step, 3)
        out[f"decode_ms_batch{B}"] = ms
        out[f"device_busy_batch{B}"] = busy
        out[f"decode_kernel_profiler_ms_batch{B}"] = prof.get(
            "ring_decode_attention")
        busy_txt = "not measured" if busy is None else f"{busy:.4f}"
        kern = prof.get("ring_decode_attention")
        say(f"  {name} serve: {ms:.4f} ms per decode step at batch {B} "
            f"(host clock, ending in synchronize); device busy {busy_txt} "
            f"of {call_us:.1f} us per step (profiler); bound "
            f"{step_bound:.4f} ms ({nbytes / 1e9:.3f} GB of weights at "
            f"3.35 TB/s); ring_decode_attention "
            + ("not on the path" if kern is None else
               f"{kern * 1e3:.2f} us per launch on the path (profiler)"))
    return out


def time_decode_shapes(cases, lse: bool = False) -> dict:
    """``ring_decode_attention`` at the other LMs' decode geometries
    (``cases.LM_DECODE_CASES``): device time per launch, its plain
    version's, one ``F.scaled_dot_product_attention`` call on the same
    tensors with the validity mask, and the bound.  ``lse``: the calls
    take ``return_lse`` (a rank's slice of a split cache,
    ``cases.SLICE_DECODE_CASES``), and the kernel is timed without it
    too."""
    import torch.nn.functional as F

    from repro_torch.kernels.ring_decode import (
        ring_decode_attention, ring_decode_attention_plain)

    shapes = {}
    for case in cases:
        q, k, v, seq = _decode_call(case)
        B, S, H, KV, d = case.batch, case.window, case.q_heads, \
            case.kv_heads, case.head_dim
        slot = torch.arange(S, device=DEVICE_TYPE)
        mask = ((slot < seq) | (seq >= S))[None, None, None, :] \
            .expand(B, 1, 1, S)
        qs, ks, vs = q[:, :, None], k.permute(0, 2, 1, 3), \
            v.permute(0, 2, 1, 3)
        kw = dict(case.kwargs, return_lse=True) if lse else case.kwargs
        ms = _held_ms(lambda: ring_decode_attention(q, k, v, seq, **kw), 200)
        bare_ms = _held_ms(lambda: ring_decode_attention(
            q, k, v, seq, **case.kwargs), 200) if lse else None
        plain_ms = _event_ms(
            lambda: ring_decode_attention_plain(q, k, v, seq, **kw), 20)
        lib_ms = _held_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), 200)
        valid = S if seq >= S else seq
        b_ms, by = _decode_bound(B, H, KV, d, valid)
        shapes[case.name] = {"slots": S, "valid": valid, "ms": ms,
                             "plain_ms": plain_ms, "library_ms": lib_ms,
                             "bound_ms": b_ms, "bound_by": by}
        if lse:
            shapes[case.name]["ms_without_lse"] = bare_ms
        say(f"    ring_decode_attention {case.name}"
            + (" (return_lse)" if lse else "") + f": {ms * 1e3:8.2f} "
            f"us/launch (device)"
            + (f", {bare_ms * 1e3:.2f} without the flag" if lse else "")
            + f", plain {plain_ms * 1e3:9.2f} us, library "
            f"(SDPA) {lib_ms * 1e3:8.2f} us, bound {b_ms * 1e3:.4f} us "
            f"({by})")
    return shapes


def serve_new_lms(golden_dir, draws: dict) -> tuple[dict, dict, dict]:
    """Phase 3's checks and phase 4's timing of every LM path but
    gemma3-1b, one resident at a time (moved to the card from its host
    draw, served, timed, freed): returns each path's launch counts and
    timings by name, and the host draws that phases 12 and 13 serve
    again."""
    counts, timings, trees = {}, {}, {}
    kept = {name for name, _ in TP_SERVED} | {TP_TRAINED} | set(SP_SERVED)
    for path in LM_PATHS[1:]:
        t0 = time.perf_counter()
        if path.name in kept:
            cfg, params, trees[path.name] = lm_setup(path.name, draws,
                                                     keep_tree=True)
        else:
            cfg, params = lm_setup(path.name, draws)
        with np.load(golden_dir / f"{path.name}.golden.npz") as g:
            golden = {k: g[k] for k in g.files}
        t1 = time.perf_counter()
        counts[path.name] = path_lm(cfg, params, golden, path)
        t2 = time.perf_counter()
        timings[f"{path.name} serve"] = time_lm(cfg, params, path)
        say(f"  {path.name}: set up in {t1 - t0:.1f} s, served and held "
            f"in {t2 - t1:.1f} s, timed in {time.perf_counter() - t2:.1f} "
            f"s")
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return counts, timings, trees


# ---------------------------------------------------------------------------
# Phase 9: training on the card.
# ---------------------------------------------------------------------------

#: The reduced configs of the other block kinds, trained 2 steps on the
#: card and on the CPU from the same params.
TRAIN_KINDS = ("recurrentgemma-2b", "granite-moe-1b-a400m",
               "deepseek-moe-16b", "mamba2-780m", "whisper-tiny",
               "llama-3.2-vision-90b")
#: Timed full-width steps (after one warm-up) and their shapes: the
#: golden's, and a batch of 4,096 tokens.
TRAIN_TIMED_STEPS = 5
TRAIN_TIMED_SHAPES = ((2, 128), (8, 512))
#: Bytes the optimizer moves a parameter: the gradient read twice (the
#: global norm, the update), params, mu and nu read and written (fp32).
OPTIMIZER_BYTES_PER_PARAM = 4 * (2 + 3 * 2)


def _attended_pairs(seq: int, window: int) -> int:
    """The (query, key) pairs of one head over a sequence of ``seq``
    where each query sees itself and up to ``window - 1`` keys before
    it: sum over i of min(i + 1, window)."""
    w = min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def train_bound(cfg, tokens: int, seq: int, n_params: int) -> dict:
    """The least time of one full-width train step of an attention-only
    config at ``tokens`` tokens of ``seq``: bf16 products (every layer's
    weight products, 2 FLOPs a weight a token forward, 4 backward, 2
    more where the remat policy recomputes a group) at 989 TFLOP/s; fp32
    products (the unembedding, 6 x vocab x d_model FLOPs a token, and
    the attention scores and values, 4 x head_dim FLOPs a head a pair
    the causal mask keeps, a ``local`` layer's within its window) at 67
    TFLOP/s; the optimizer's bytes at 3.35 TB/s.  The bound is the
    largest of the three."""
    from repro_torch.models.transformer import _layer_seq, layer_kinds

    lead, g, _ = _layer_seq(cfg)
    grouped = set(range(lead, lead + g * len(cfg.pattern)))
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    attn_w = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    mlp_w = d * cfg.d_ff * (3 if cfg.mlp in ("geglu", "swiglu") else 2)
    bf16 = fp32 = 0
    for i, kind in enumerate(layer_kinds(cfg)):
        passes = 8 if (i in grouped and cfg.remat_policy != "none") else 6
        bf16 += passes / 2 * 2 * (attn_w + mlp_w) * tokens
        pairs = _attended_pairs(seq, cfg.window if kind == "local" else seq)
        fp32 += passes / 2 * 4 * tokens // seq * pairs * h * hd
    fp32 += 6 * cfg.vocab * d * tokens
    opt_bytes = OPTIMIZER_BYTES_PER_PARAM * n_params
    parts = {"bf16_ms": bf16 / BF16_OPS_PER_S * 1e3,
             "fp32_ms": fp32 / CUDA_CORE_OPS_PER_S * 1e3,
             "optimizer_ms": opt_bytes / HBM_BYTES_PER_S * 1e3}
    return {"bound_ms": max(parts.values()), "bf16_flops": bf16,
            "fp32_flops": fp32, "optimizer_bytes": opt_bytes, **parts}


def _train_state_on_card(tree):
    """The fp32 train state of a reference-layout host tree, on the card."""
    from repro_torch.train import init_state
    from repro_torch.train.tree import leaves, unflatten_like

    return init_state(unflatten_like(tree, [
        torch.from_numpy(np.asarray(a, np.float32)).to(DEVICE_TYPE)
        for a in leaves(tree)]))


def time_train(cfg, state, step_fn, shapes=TRAIN_TIMED_SHAPES) -> dict:
    """The full-width step's median host-clock time over
    ``TRAIN_TIMED_STEPS`` steps after a warm-up (each ending in
    synchronize), its device-busy share (torch.profiler over 2 steps),
    the peak memory allocated and tokens/s, beside its bound, at each of
    ``shapes``."""
    from repro_torch.train import synthetic_batch

    n_params = sum(t.numel() for t in _leaves(state.params))
    out = {}
    for B, S in shapes:
        batch = synthetic_batch(cfg, B, S, 0, device=DEVICE_TYPE)
        torch.cuda.reset_peak_memory_stats()

        def step():   # the state is updated in place; the same work
            step_fn(state, batch)
        ms = _host_ms(step, TRAIN_TIMED_STEPS)
        busy, call_us, _, _ = _device_busy(step, 2)
        peak = torch.cuda.max_memory_allocated()
        bound = train_bound(cfg, B * S, S, n_params)
        row = {"step_ms": ms, "device_busy": busy, "tokens_per_s":
               B * S / ms * 1e3, "max_memory_allocated": peak, **bound}
        out[f"{B}x{S}"] = row
        busy_txt = "not measured" if busy is None else f"{busy:.4f}"
        say(f"  {cfg.name} train step at batch {B} x {S} tokens: "
            f"{ms:.3f} ms median of {TRAIN_TIMED_STEPS} after a warm-up "
            f"(host clock, ending in synchronize), "
            f"{row['tokens_per_s']:,.0f} tokens/s; device busy {busy_txt} "
            f"of {call_us:.0f} us a step (profiler); "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; bound "
            f"{bound['bound_ms']:.3f} ms (bf16 products "
            f"{bound['bf16_flops'] / 1e12:.3f} TFLOP at 989 TFLOP/s "
            f"{bound['bf16_ms']:.3f} ms, fp32 products "
            f"{bound['fp32_flops'] / 1e12:.3f} TFLOP at 67 TFLOP/s "
            f"{bound['fp32_ms']:.3f} ms, optimizer "
            f"{bound['optimizer_bytes'] / 1e9:.2f} GB at 3.35 TB/s "
            f"{bound['optimizer_ms']:.3f} ms); {nvidia_smi_line()}")
    return out


def train_other_kinds() -> None:
    """Each other kind's reduced config: 2 steps on the card and on the
    CPU from the same params (``lm_params(cfg, SEED)``) and batches,
    each step's loss within rtol 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.cases import TRAIN_RTOL, lm_params
    from repro_torch.models import build_model
    from repro_torch.train import init_state, make_train_step, \
        synthetic_batch
    from repro_torch.train.tree import leaves, unflatten_like

    for name in TRAIN_KINDS:
        cfg = get_config(name).reduced()
        tree = lm_params(cfg, SEED)
        losses = {}
        for device in ("cpu", DEVICE_TYPE):
            state = init_state(unflatten_like(tree, [
                torch.from_numpy(np.array(a, np.float32)).to(device)
                for a in leaves(tree)]))
            step = make_train_step(build_model(cfg))
            losses[device] = []
            for i in range(2):
                state, m = step(state, synthetic_batch(cfg, 4, 32, i,
                                                       device=device))
                losses[device].append(float(m["loss"]))
        got, want = np.array(losses[DEVICE_TYPE]), np.array(losses["cpu"])
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        if not np.isfinite(got).all() or err > TRAIN_RTOL:
            raise SystemExit(f"phase 9: {cfg.name} losses on the card "
                             f"{got} against the CPU's {want}")
        say(f"  {cfg.name}: 2 steps at 4 x 32 on the card, losses "
            f"{got.round(5).tolist()} within {err:.2e} of the CPU's")


def phase_train(cfg, tree, golden) -> tuple[dict, dict]:
    """Phase 9: gemma3-1b trained at full width on the card from the
    serve path's host draw, held to the reference's train golden; a
    checkpoint saved asynchronously, restored and stepped beside the
    live state; the trained tree served through ``ring_decode_attention``;
    then every other kind's reduced config; then the timing.  Returns the
    serve's launch counts and the timing record."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.cases import TRAIN_RTOL, hold_train_golden
    from repro_torch.models import build_model, params_from_reference
    from repro_torch.train import make_train_step, synthetic_batch
    from repro_torch.train.train_step import eval_state_shapes
    from repro_torch.train.tree import leaves

    say(f"phase 9: {cfg.name} trained at full width on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launch_counts()
    held = hold_train_golden(cfg, tree, golden, DEVICE_TYPE)
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        raise SystemExit(f"phase 9: training launched ring kernels "
                         f"{launch_counts()}")
    if not held["ok"]:
        raise SystemExit(f"phase 9: {cfg.name} misses the reference's "
                         f"train golden: {held['errs']} (data "
                         f"{held['same_data']}; {held['metrics']})")
    state, opt = held["state"], held["opt"]
    B, S = int(golden["batch"]), int(golden["seq"])
    n_params = sum(t.numel() for t in leaves(state.params))
    say(f"  the reference's train golden held ({n_params:,} parameters, "
        f"batch {B} x {S}, {len(held['metrics'])} steps, "
        f"{time.perf_counter() - t0:.1f} s, no ring kernel launched): "
        f"worst relative errors {held['errs']} (limit {TRAIN_RTOL}); "
        f"loss / grad_norm / lr by step "
        + "; ".join(f"{m['loss']:.5f} / {m['grad_norm']:.5f} / "
                    f"{m['lr']:.3g}" for m in held["metrics"]))

    model = build_model(cfg)
    step_fn = make_train_step(model, opt=opt)
    ckpt_root = ROOT / "build"
    ckpt_root.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ckpt_root) as d:
        mgr = CheckpointManager(d)
        n = int(state.step)
        mgr.save_async(n, state)
        snap_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        restored = mgr.restore(eval_state_shapes(model), device=DEVICE_TYPE)
        load_s = time.perf_counter() - t0 - save_s
    if not all(torch.equal(a, b) for a, b in zip(leaves(restored),
                                                 leaves(state))):
        raise SystemExit("phase 9: the restored state differs from the "
                         "saved one")
    batch = synthetic_batch(cfg, B, S, n, device=DEVICE_TYPE)
    _, live_m = step_fn(state, batch)
    restored, back_m = step_fn(restored, batch)
    live, back = float(live_m["loss"]), float(back_m["loss"])
    if not abs(live - back) <= 1e-5 * abs(live):
        raise SystemExit(f"phase 9: step {n} from the restored state: loss "
                         f"{back} against the live state's {live}")
    say(f"  checkpoint of step {n}: save_async returned after {snap_s:.1f} "
        f"s (host copy), written in {save_s:.1f} s, restored in "
        f"{load_s:.1f} s, bitwise the saved state; step {n} from both: "
        f"loss {live:.6f} and {back:.6f}")
    del restored

    serve = params_from_reference(cfg, state.params, DEVICE_TYPE)
    path = dataclasses.replace(LM_PATHS[0], max_new=8)
    counts = path_lm(cfg, serve, None, path)
    say(f"  the trained tree served: {counts['ring_decode_attention']} "
        f"ring_decode_attention launches ({path.per_step} a decode step), "
        f"logits within the plain path's tolerance")
    del serve
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    train_other_kinds()
    timing = time_train(cfg, state, step_fn)
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts, timing


# ---------------------------------------------------------------------------
# Phases 10 and 11: the mesh path, on a one-card NCCL mesh and on gloo
# ranks on the host CPU.
# ---------------------------------------------------------------------------

#: The mesh phase's serve path: phase 3's gemma3-1b prompts, fewer new
#: tokens (its teacher-forced check runs both paths on the mesh).
MESH_LM_MAX_NEW = 8
#: The mesh phase times its train step at the golden's shape only.
MESH_TRAIN_SHAPES = TRAIN_TIMED_SHAPES[:1]


def _state_shardings(rules, state):
    """The shardings of a train state's leaves by ``rules`` (the step
    unplaced)."""
    return state._replace(step=None,
                          params=rules.params_shardings(state.params),
                          mu=rules.params_shardings(state.mu),
                          nu=rules.params_shardings(state.nu))


def phase_mesh(cfg, tree, lm_golden, train_golden, unsharded) -> tuple:
    """Phase 10: gemma3-1b at full width and depth on a one-card NCCL
    mesh (``make_host_mesh(1, 1)``, ``make_rules`` of the decode and the
    train cell): served from DTensor params (``params_shardings``) with
    phase 3's checks and 26 ``ring_decode_attention`` launches a decode
    step, then timed beside phase 4's unsharded step; trained on DTensor
    state against the reference's train golden; its state saved and
    restored with ``shardings=`` (bitwise the live state); its step
    timed and its peak memory beside phase 9's.  Returns the serve's
    launch counts and the timings."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import DECODE_32K, TRAIN_4K
    from repro_torch.kernels.cases import TRAIN_RTOL, hold_train_golden
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import make_rules
    from repro_torch.models import build_model, params_from_reference
    from repro_torch.parallel import place_tree
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import eval_state_shapes
    from repro_torch.train.tree import leaves

    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 1)
    backend = dist.get_backend()
    say(f"phase 10: {cfg.name} at full width on a one-card mesh "
        f"({backend}, {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
        f"{mesh.device_type})")
    if backend != "nccl" or mesh.device_type != DEVICE_TYPE:
        raise SystemExit(f"phase 10: the mesh is {backend} on "
                         f"{mesh.device_type}, not nccl on {DEVICE_TYPE}")
    try:
        decode_rules = make_rules(cfg, mesh, DECODE_32K)
        train_rules = make_rules(cfg, mesh, TRAIN_4K)
        params = params_from_reference(cfg, tree, DEVICE_TYPE)
        params = place_tree(params, decode_rules.params_shardings(params))
        n_dt = sum(is_dtensor(t) for t in _leaves(params))
        say(f"  serve params: {n_dt} of {len(list(_leaves(params)))} "
            f"leaves DTensors placed by params_shardings")
        path = dataclasses.replace(LM_PATHS[0], max_new=MESH_LM_MAX_NEW)
        counts = path_lm(cfg, params, lm_golden, path, rules=decode_rules)
        timing = {"serve": time_lm(cfg, params, rules=decode_rules)}
        for B in (1, len(path.prompt_lens)):
            ms = timing["serve"][f"decode_ms_batch{B}"]
            was = unsharded[f"decode_ms_batch{B}"]
            say(f"  decode at batch {B}: {ms:.3f} ms a step, {B / ms * 1e3:.1f}"
                f" tokens/s on the mesh; unsharded (phase 4) {was:.3f} ms, "
                f"{B / was * 1e3:.1f} tokens/s; {nvidia_smi_line()}")
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        held = hold_train_golden(cfg, tree, train_golden, DEVICE_TYPE,
                                 rules=train_rules)
        torch.cuda.synchronize()
        if not held["ok"]:
            raise SystemExit(f"phase 10: {cfg.name} on the mesh misses the "
                             f"reference's train golden: {held['errs']} "
                             f"(data {held['same_data']})")
        state = held["state"]
        say(f"  the reference's train golden held on DTensor state: worst "
            f"relative errors {held['errs']} (limit {TRAIN_RTOL}); loss / "
            f"grad_norm by step "
            + "; ".join(f"{m['loss']:.5f} / {m['grad_norm']:.5f}"
                        for m in held["metrics"]))
        model = build_model(cfg)
        like = eval_state_shapes(model)
        t1 = time.perf_counter()
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            mgr = CheckpointManager(d)
            mgr.save(int(state.step), state)
            save_s = time.perf_counter() - t1
            restored = mgr.restore(like, device=DEVICE_TYPE,
                                   shardings=_state_shardings(train_rules,
                                                              like))
            load_s = time.perf_counter() - t1 - save_s
        for got, want in zip(leaves(restored), leaves(state)):
            if is_dtensor(want):
                same = is_dtensor(got) and got.placements == \
                    want.placements and torch.equal(got.to_local(),
                                                    want.to_local())
            else:
                same = torch.equal(got, want)
            if not same:
                raise SystemExit("phase 10: the restored sharded state "
                                 "differs from the live one")
        say(f"  sharded checkpoint of step {int(state.step)}: written in "
            f"{save_s:.1f} s, restored with shardings= in {load_s:.1f} s, "
            f"bitwise the live DTensor state")
        del restored
        step_fn = make_train_step(model, train_rules, opt=held["opt"])
        timing["train"] = time_train(cfg, state, step_fn, MESH_TRAIN_SHAPES)
        peak = timing["train"]["2x128"]["max_memory_allocated"]
        say(f"  max_memory_allocated at 2 x 128 on the mesh {peak / 2**30:.2f}"
            f" GiB (phase 9, unsharded: 19.51 GiB in chip run 6 of PR 35); "
            f"phase 10 took {time.perf_counter() - t0:.1f} s")
        del state, held
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return counts, timing


def phase_gloo() -> dict:
    """Phase 11: ``tools/mesh_check.py`` on the card machine's host CPU:
    4 gloo ranks hold the mesh path against one process (tensor and
    sequence parallelism and global MoE routing among it)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import mesh_check

    say(f"phase 11: the mesh path on {mesh_check.RANKS} gloo ranks on the "
        f"host CPU (no card), against one process")
    t0 = time.perf_counter()
    record = mesh_check.run()
    record["wall_s"] = time.perf_counter() - t0
    train = record["training"]
    for label, row in train.items():
        if label == "one_process":
            continue
        say(f"  {label}: losses {row['loss']} (one process "
            f"{train['one_process']['loss']}), relative errors "
            f"{row['rel_err']}, parameters after step 3 at "
            f"{row['params_worst_of_tolerance']:.3f} of the tolerance; "
            f"bf16 loss errors {row.get('bf16_rel_err', 'not run')}")
    for label, row in {**record["tensor_parallel"],
                       **record["sequence_parallel"]}.items():
        if "rel_err" in row:
            say(f"  {label}: losses {row['loss']}, relative errors "
                f"{row['rel_err']} against one process; the first step's "
                f"gradients at {row['grads_worst_of_tolerance']:.3f} of the "
                f"tolerance; tokens {row['tokens']}")
    say(f"  collectives {record['collectives']}; checkpoint "
        f"{record['checkpoint']}; served tokens equal one process's; "
        f"refusals {record['refusals']}; "
        f"{record['wall_s']:.1f} s on the host CPU")
    return record


# ---------------------------------------------------------------------------
# Phase 12: tensor parallelism over a model axis, the ranks as threads of
# one process on the card.
# ---------------------------------------------------------------------------

#: The phase's served configs and the model ranks of each, and the
#: config trained a step on two model ranks.
TP_SERVED = (("granite-moe-1b-a400m", (2, 4)), ("mamba2-780m", (2,)))
TP_TRAINED = "granite-moe-1b-a400m"
#: Tokens each served path generates over the model ranks (phase 3's
#: prompts; fewer new tokens, as phase 10's mesh path: the ranks run one
#: at a time, so a step costs R times the host work).
TP_MAX_NEW = 8
#: Decode steps each per-token time takes the median of (fewer than the
#: unsharded paths' 20: a step over 4 ranks takes near a second).
TP_TIMED_STEPS = 5


def _tp_ranks(cfg, R: int, params):
    """``(mesh, rules, per-rank params)`` of ``R`` model ranks on the
    card (``StandInMesh((1, R))``, the decode cell's rules): each rank's
    tree its own contiguous copy of ``rules.rank_tree(params)``, as a
    rank of a process group would hold it."""
    from repro_torch.configs.base import DECODE_32K
    from repro_torch.launch.specs import make_rules
    from repro_torch.parallel.standin import StandInMesh
    from repro_torch.train.tree import tree_map

    mesh = StandInMesh((1, R), device_type=DEVICE_TYPE)
    rules = make_rules(cfg, mesh, DECODE_32K)
    rules.check(cfg)
    mine = {c: tree_map(lambda t: t.contiguous().clone(),
                        rules.rank_tree(params, c)) for c in mesh.coords()}
    torch.cuda.synchronize()
    return mesh, rules, mine


def path_lm_tp(cfg, whole, golden, path: LMPath, R: int) -> dict:
    """An LM served over ``R`` model ranks on the card, phase 3's checks:
    ``ServingEngine(rules=...).generate`` on each rank (the same tokens on
    every rank, exactly ``path.per_step`` ``ring_decode_attention``
    launches a decode step on each); each step's logits, teacher-forced
    on those tokens and gathered over the ranks' vocabulary rows, within
    the bf16 tolerance of the plain path's over the same ranks
    (:func:`hold_forced`); the reference's full-width golden at batch 1
    on every rank (:func:`hold_golden`).  Returns the counts and the
    ranks' params with their mesh and rules."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ring_decode import thread_launches
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    name = f"{path.name} over {R} model ranks"
    mesh, rules, mine = _tp_ranks(cfg, R, whole)
    model, plain = build_model(cfg), build_model(cfg, plain=True)
    prompts, padded = lm_prompts_of_path(cfg, path.prompt_lens)
    B = len(prompts)

    def generate(c):
        before = thread_launches()
        out = ServingEngine(model, mine[c], rules=rules,
                            cache_len=path.cache_len).generate(
            prompts, max_new=path.max_new)
        return out, thread_launches() - before
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    runs = mesh.run(generate)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launch_counts()
    out = runs[(0, 0)][0]
    per_rank = {c: n for c, (_, n) in runs.items()}
    want = path.per_step * path.max_new
    total = {k: n for k, n in counts.items() if n}
    if any(n != want for n in per_rank.values()) or total != (
            {"ring_decode_attention": want * R} if want else {}):
        raise SystemExit(f"{name}: launches {total}, by rank {per_rank}, "
                         f"are not {path.per_step} a decode step on each "
                         "rank")
    if any(o != out for o, _ in runs.values()) or [len(o) for o in out] \
            != [path.max_new] * B:
        raise SystemExit(f"{name}: the ranks' tokens differ or are short: "
                         f"{runs}")
    say(f"  {name}: generate made {path.per_step} ring_decode_attention "
        f"launches a decode step on each rank ({per_rank}; "
        f"{sum(total.values())} in all) at batch {B}; {gen_s:.2f} s")

    forced = mesh.run(lambda c: [
        forced_steps(m, mine[c], padded, out, path, rules=rules)
        for m in (model, plain)])
    kern, ref = forced[(0, 0)]
    if any(any(not np.array_equal(a, b) for a, b in zip(k[0], kern[0]))
           for k, _ in forced.values()):
        raise SystemExit(f"{name}: the ranks' logits differ")
    hold_forced(name, cfg, kern, ref, out, path.max_new,
                f"{B} prompts of {list(path.prompt_lens)} tokens, the "
                "ranks' logits gathered")
    held = mesh.run(lambda c: golden_rows(model, mine[c], golden, rules))
    if any(rows != held[(0, 0)][1] or not h["ok"]
           for h, rows in held.values()):
        raise SystemExit(f"{name}: the ranks' golden checks differ or "
                         f"fail: {held}")
    hold_golden(f"{name}, every rank", cfg, *held[(0, 0)], golden)
    torch.cuda.synchronize()
    return counts, (mesh, rules, mine)


def time_lm_tp(cfg, ranks, path: LMPath, unsharded: dict) -> dict:
    """Per-token decode latency at batch 1 and 4 over the model ranks
    (host clock from starting the ranks' threads to synchronize) and the
    busy share (torch.profiler), beside phase 4's unsharded numbers."""
    from repro_torch.models import build_model

    mesh, rules, mine = ranks
    model = build_model(cfg)
    _, padded = lm_prompts_of_path(cfg, path.prompt_lens)
    R = rules.model_ranks()
    out = {}
    for B in (1, len(padded)):
        toks = padded[-B:]
        state = mesh.run(lambda c: model.prefill(
            mine[c], toks, cache_len=path.cache_len, rules=rules))
        tok = state[(0, 0)][0].argmax(-1)   # a rank's rows; any token

        def step():   # the same step again: the same work every call
            mesh.run(lambda c: model.decode_step(
                mine[c], state[c][1], tok, state[c][2], rules=rules))
        ms = _host_ms(step, TP_TIMED_STEPS)
        busy, call_us, prof, _ = _device_busy(step, 2)
        was = unsharded[f"decode_ms_batch{B}"]
        out[f"decode_ms_batch{B}"] = ms
        out[f"device_busy_batch{B}"] = busy
        out[f"decode_kernel_profiler_ms_batch{B}"] = prof.get(
            "ring_decode_attention")
        busy_txt = "not measured" if busy is None else f"{busy:.4f}"
        kern = prof.get("ring_decode_attention")
        say(f"  {cfg.name} over {R} model ranks: {ms:.4f} ms per decode "
            f"step at batch {B} (host clock, the ranks' threads started to "
            f"synchronize), device busy {busy_txt} of {call_us:.1f} us "
            f"(profiler); unsharded (phase 4) {was:.4f} ms, busy "
            f"{unsharded[f'device_busy_batch{B}']}; ring_decode_attention "
            + ("not on the path" if kern is None else
               f"{kern * 1e3:.2f} us per launch (profiler, each rank "
               f"{cfg.n_heads // R} q heads on "
               f"{cfg.n_kv_heads // R} KV heads)")
            + f"; {nvidia_smi_line()}")
    return out


def _update_norm(before: list, after: list) -> float:
    """The norm of ``after - before`` over the leaves, in fp64."""
    return float(sum(float((a.double() - b.double()).square().sum())
                     for a, b in zip(after, before)) ** 0.5)


def train_tp(cfg, tree, R: int = 2, label: str = "phase 12") -> dict:
    """One full-width train step (bf16 activations, fp32 masters, the
    train golden's batch and optimizer, remat ``"none"``) unsharded and
    over ``R`` model ranks on the card (``standin_train_step``): loss,
    grad_norm and the update's norm within ``TRAIN_RTOL``."""
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.kernels.cases import (TRAIN_GOLDEN_BATCH,
                                           TRAIN_GOLDEN_OPT,
                                           TRAIN_GOLDEN_SEQ, TRAIN_RTOL)
    from repro_torch.launch.specs import make_rules
    from repro_torch.models import build_model
    from repro_torch.parallel.standin import StandInMesh
    from repro_torch.train import AdamWConfig, make_train_step, \
        synthetic_batch
    from repro_torch.train.train_step import (standin_states,
                                              standin_train_step)
    from repro_torch.train.tree import leaves, leaves_with_paths, \
        unflatten_like

    model, opt = build_model(cfg), AdamWConfig(**TRAIN_GOLDEN_OPT)
    batch = synthetic_batch(cfg, TRAIN_GOLDEN_BATCH, TRAIN_GOLDEN_SEQ, 0,
                            device=DEVICE_TYPE)
    state = _train_state_on_card(tree)
    start = unflatten_like(state.params,
                           [p.clone() for p in leaves(state.params)])
    t0 = time.perf_counter()
    state, m1 = make_train_step(model, opt=opt, remat_policy="none")(
        state, batch)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    want = {"loss": float(m1["loss"]), "grad_norm": float(m1["grad_norm"]),
            "update_norm": _update_norm(leaves(start), leaves(state.params))}
    del state
    torch.cuda.empty_cache()

    mesh = StandInMesh((1, R), device_type=DEVICE_TYPE)
    rules = make_rules(cfg, mesh, TRAIN_4K)
    states = standin_states(rules, start)
    del start
    torch.cuda.empty_cache()
    before = {c: [p.clone() for p in leaves(s.params)]
              for c, s in states.items()}
    t0 = time.perf_counter()
    states, m = standin_train_step(model, rules, opt=opt)(states, batch)
    torch.cuda.synchronize()
    tp_s = time.perf_counter() - t0
    sq = 0.0
    like = states[(0, 0)].params
    for i, (path, x) in enumerate(leaves_with_paths(like)):
        owners = mesh.coords() if rules.model_dim(path, x.ndim) is not None \
            else [(0, 0)]
        for c in owners:
            a, b = leaves(states[c].params)[i], before[c][i]
            sq += float((a.double() - b.double()).square().sum())
    got = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "update_norm": sq ** 0.5}
    errs = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    if not all(np.isfinite(list(got.values()))) or \
            max(errs.values()) > TRAIN_RTOL:
        raise SystemExit(f"{label}: {cfg.name}'s step over {R} model ranks "
                         f"{got} against the unsharded step's {want}")
    say(f"  {cfg.name} train step at {TRAIN_GOLDEN_BATCH} x "
        f"{TRAIN_GOLDEN_SEQ} over {R} model ranks: loss, grad_norm, update "
        f"norm {got} against the unsharded step's {want} (relative "
        f"{errs}; limit {TRAIN_RTOL}); {tp_s:.2f} s against {one_s:.2f} s "
        f"(host clock, first step of each)")
    del states, before
    torch.cuda.empty_cache()
    return {"tp": got, "unsharded": want, "rel_err": errs,
            "tp_s": tp_s, "unsharded_s": one_s}


def phase_tp(trees: dict, paths: dict) -> tuple[dict, dict]:
    """Phase 12: granite-moe-1b-a400m at full width served over 2 and 4
    model ranks and mamba2-780m over 2, each with phase 3's checks and
    its golden (``path_lm_tp``) and its decode timed beside phase 4's
    unsharded step; one granite-moe train step over 2 model ranks beside
    the unsharded step.  Returns the launch counts by path and the
    timings."""
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_reference

    t0 = time.perf_counter()
    say("phase 12: tensor parallelism on the card: the model ranks as "
        "threads of one process (StandInMesh), each rank its heads, "
        "experts, d_ff and vocabulary rows")
    counts, timings = {}, {}
    by_name = {p.name: dataclasses.replace(p, max_new=TP_MAX_NEW)
               for p in LM_PATHS}
    for name, ranks in TP_SERVED:
        cfg = get_config(name)
        whole = params_from_reference(cfg, trees[name], DEVICE_TYPE)
        with np.load(ASSETS / f"{name}.golden.npz") as g:
            golden = {k: g[k] for k in g.files}
        for R in ranks:
            key = f"{name} model={R}"
            counts[key], tp = path_lm_tp(cfg, whole, golden, by_name[name],
                                         R)
            timings[key] = time_lm_tp(cfg, tp, by_name[name],
                                      paths[f"{name} serve"])
            del tp
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        del whole
        torch.cuda.empty_cache()
    cfg = get_config(TP_TRAINED)
    timings[f"{TP_TRAINED} train model=2"] = train_tp(cfg, trees[TP_TRAINED])
    say(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    return counts, timings


# ---------------------------------------------------------------------------
# Phase 13: sequence parallelism, the ranks as threads of one process on
# the card.
# ---------------------------------------------------------------------------

#: The phase's model ranks for gemma3-1b's decode and prefill cells and
#: its long-context meshes ``(data, model)``, the other configs it serves
#: from their host draws, and the tokens each served path generates.
SP_RANKS = (2, 4)
SP_SERVED = ("recurrentgemma-2b", "whisper-tiny")
SP_LONG_SHAPES = ((2, 1), (2, 2))
SP_MAX_NEW = 8
#: Decode steps each per-token time takes the median of.
SP_TIMED_STEPS = 5
#: The range that the carry checks slow recurrentgemma-2b's
#: ``lru_lambda`` to: ``a_t`` near ``1 - 1e-3`` (as drawn, in [0.9,
#: 0.999], it is near ``exp(-30)`` and the scan's carry is gone a step
#: into a rank's run), so that every earlier rank's carry reaches each run.
SP_SLOW_LAMBDA = (-1.2, -0.9)


def _sp_ranks(cfg, params, shape, cell):
    """``(mesh, rules, per-rank params)`` of ``StandInMesh(shape)`` on the
    card under ``cell``'s rules: each rank's tree ``rules.rank_tree`` of
    ``params`` (views: the ranks only read their weights, and the
    replicated ones need no copy on one card)."""
    from repro_torch.launch.specs import make_rules
    from repro_torch.parallel.standin import StandInMesh

    mesh = StandInMesh(shape, device_type=DEVICE_TYPE)
    rules = make_rules(cfg, mesh, cell)
    rules.check(cfg)
    return mesh, rules, {c: rules.rank_tree(params, c)
                         for c in mesh.coords()}


def _first(out: dict):
    return out[min(out)]


def _nbytes(x) -> int:
    """The bytes of the tensors of a cache (a tensor or a tuple)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return sum(_nbytes(t) for t in x) if isinstance(x, tuple) else 0


def _cache_bytes(caches) -> tuple[int, int]:
    """``(bytes of the kv_seq slices, bytes of every other cache)`` of a
    rank's caches."""
    from repro_torch.models.common import KVSlice
    from repro_torch.models.transformer import CrossCache

    sliced = other = 0
    for c in caches:
        for part in ((c.self_kv, c.mem_k, c.mem_v)
                     if isinstance(c, CrossCache) else (c,)):
            if isinstance(part, KVSlice):
                sliced += _nbytes(part)
            else:
                other += _nbytes(part)
    return sliced, other


def unsharded_serve(cfg, whole, path: LMPath, prompts, padded, memory):
    """The unsharded path's tokens (``generate``) and its plain path's
    logits teacher-forced on them: what phase 13's ranks are held to."""
    from repro_torch.models import build_model
    from repro_torch.serve import ServingEngine

    out = ServingEngine(build_model(cfg), whole,
                        cache_len=path.cache_len).generate(
        prompts, max_new=path.max_new, memory=memory)
    plain = forced_steps(build_model(cfg, plain=True), whole, padded, out,
                         path, memory)
    return out, plain


def serve_sp(cfg, whole, golden, path: LMPath, shape, cell, want,
             unsharded: dict | None = None) -> dict:
    """An LM served on ``StandInMesh(shape)`` under ``cell``'s rules
    (``kv_seq`` split where the KV heads do not divide, or over the data
    axis under ``long_context``): ``generate`` on each rank, the same
    tokens on every rank and the unsharded path's (``want``, from
    :func:`unsharded_serve`), exactly ``path.per_step``
    ``ring_decode_attention`` launches a decode step on each rank, those
    on the global caches' slices with ``return_lse``; the kernel path's
    logits teacher-forced on them within the bf16 tolerance of the
    unsharded plain path's; the golden at batch 1 on every rank (given
    one); each rank's cache bytes against the unsharded caches'; and the
    decode per token at batch 1 and the batch's, with its busy share,
    beside phase 4's unsharded step (``unsharded``).  Returns the counts
    and the timings."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ring_decode import thread_launches
    from repro_torch.models import build_model
    from repro_torch.models.transformer import (ATTN_KINDS, kv_split,
                                                layer_kinds)
    from repro_torch.serve import ServingEngine

    name = f"{path.name} {cell.name} on {shape} (data, model)"
    mesh, rules, mine = _sp_ranks(cfg, whole, shape, cell)
    model = build_model(cfg)
    prompts, padded = lm_prompts_of_path(cfg, path.prompt_lens)
    memory = lm_memory_of_path(cfg, len(prompts))
    B = len(prompts)
    split = sum(kv_split(cfg, "full" if k == "cross" else k,
                         path.cache_len, rules)
                for k in layer_kinds(cfg) if k in ATTN_KINDS)

    def generate(c):
        n0, l0 = thread_launches(), thread_launches(lse=True)
        out = ServingEngine(model, mine[c], rules=rules,
                            cache_len=path.cache_len).generate(
            prompts, max_new=path.max_new, memory=memory)
        return out, thread_launches() - n0, thread_launches(lse=True) - l0
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    runs = mesh.run(generate)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launch_counts()
    out = _first(runs)[0]
    per_rank = {c: (n, m) for c, (_, n, m) in runs.items()}
    if any(n != path.per_step * path.max_new or m != split * path.max_new
           for n, m in per_rank.values()):
        raise SystemExit(f"{name}: launches (all, return_lse) by rank "
                         f"{per_rank} are not {path.per_step} and {split} a "
                         "decode step")
    if any(o != out for o, _, _ in runs.values()) or out != want[0]:
        raise SystemExit(f"{name}: the ranks' tokens {out} differ from "
                         f"each other's or the unsharded path's {want[0]}")
    say(f"  {name}: kv_seq over {rules.shards('kv_seq')} ranks; generate "
        f"made {path.per_step} ring_decode_attention launches a decode "
        f"step on each rank, {split} of them on the global caches' slices "
        f"with return_lse ({per_rank}); the unsharded path's tokens at "
        f"batch {B}; {gen_s:.2f} s")
    forced = mesh.run(lambda c: forced_steps(model, mine[c], padded, out,
                                             path, memory, rules))
    hold_forced(name, cfg, _first(forced), want[1], out, path.max_new,
                f"{B} prompts of {list(path.prompt_lens)} tokens, the "
                "ranks' logits against the unsharded plain path's")
    if golden is not None:
        held = mesh.run(lambda c: golden_rows(model, mine[c], golden,
                                              rules))
        if any(rows != _first(held)[1] or not h["ok"]
               for h, rows in held.values()):
            raise SystemExit(f"{name}: the ranks' golden checks differ or "
                             f"fail: {held}")
        hold_golden(f"{name}, every rank", cfg, *_first(held), golden)
    state = mesh.run(lambda c: model.prefill(
        mine[c], padded, cache_len=path.cache_len, memory=memory,
        rules=rules))
    one = model.prefill(whole, padded, cache_len=path.cache_len,
                        memory=memory)
    full = _cache_bytes(one[1])[1]
    rank_bytes = {c: _cache_bytes(s[1]) for c, s in state.items()}
    sliced_whole = full - _first(rank_bytes)[1]
    say(f"  {name}: cache bytes a rank at batch {B}: kv_seq slices "
        + ", ".join(f"{c}: {b[0]:,}" for c, b in rank_bytes.items())
        + f" of the unsharded {sliced_whole:,} (1/{rules.shards('kv_seq')}"
        f" = {sliced_whole / rules.shards('kv_seq'):,.0f}), plus "
        f"{_first(rank_bytes)[1]:,} whole (rings, memories)")
    del state, one
    timings = {"cache_bytes_by_rank": {str(c): b[0] for c, b in
                                       rank_bytes.items()},
               "cache_bytes_unsharded": sliced_whole, "generate_s": gen_s}
    for b in sorted({1, B}):
        toks = padded[-b:]
        mem = None if memory is None else memory[-b:]
        st = mesh.run(lambda c: model.prefill(
            mine[c], toks, cache_len=path.cache_len, memory=mem,
            rules=rules))
        tok = _first(st)[0].argmax(-1)   # a rank's rows; any token

        def step():   # the same step again: the same work every call
            mesh.run(lambda c: model.decode_step(mine[c], st[c][1], tok,
                                                 st[c][2], rules=rules))
        ms = _host_ms(step, SP_TIMED_STEPS)
        busy, call_us, prof, _ = _device_busy(step, 2)
        kern = prof.get("ring_decode_attention")
        timings[f"decode_ms_batch{b}"] = ms
        timings[f"device_busy_batch{b}"] = busy
        timings[f"decode_kernel_profiler_ms_batch{b}"] = kern
        busy_txt = "not measured" if busy is None else f"{busy:.4f}"
        was = (unsharded or {}).get(f"decode_ms_batch{b}")
        say(f"  {name}: {ms:.4f} ms per decode step at batch {b} (host "
            f"clock, the ranks' threads started to synchronize, median of "
            f"{SP_TIMED_STEPS}), device busy {busy_txt} of {call_us:.1f} us "
            f"(profiler); unsharded (phase 4) "
            + ("not run" if was is None else f"{was:.4f} ms")
            + "; ring_decode_attention "
            + ("not on the path" if kern is None else
               f"{kern * 1e3:.2f} us a launch (profiler)")
            + f"; {nvidia_smi_line()}")
        del st
    torch.cuda.synchronize()
    return counts, timings


def _tree_close(got, want) -> float:
    """max |got - want| over max |want| of two caches' tensors."""
    from repro_torch.train.tree import leaves

    worst = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        if not isinstance(a, torch.Tensor):
            continue
        scale = float(b.float().abs().max()) or 1.0
        worst = max(worst, float((a.float() - b.float()).abs().max())
                    / scale)
    return worst


def prefill_sp(cfg, whole, path: LMPath, R: int) -> dict:
    """The prefill cell's rules over ``R`` model ranks (each rank a run
    of the prompts' positions; ``fsdp_sp``): the last logits (the ranks'
    vocabulary rows gathered) within the bf16 tolerance of the unsharded
    prefill's, every cache within 2e-2 of its max (the caches are whole
    on every rank), and the prefill's time beside the unsharded one."""
    from repro_torch.configs.base import PREFILL_32K
    from repro_torch.kernels.cases import logits_close
    from repro_torch.models import build_model
    from repro_torch.models.transformer import vocab_logits

    name = f"{path.name} prefill_32k over {R} model ranks"
    mesh, rules, mine = _sp_ranks(cfg, whole, (1, R), PREFILL_32K)
    model = build_model(cfg)
    _, padded = lm_prompts_of_path(cfg, path.prompt_lens)
    memory = lm_memory_of_path(cfg, len(padded))
    n = padded.shape[1]
    runs = [b for _, b in rules.seq_slices("seq", n)]
    want = model.prefill(whole, padded, cache_len=path.cache_len,
                         memory=memory)

    def prefill():
        return mesh.run(lambda c: model.prefill(
            mine[c], padded, cache_len=path.cache_len, memory=memory,
            rules=rules))
    got = prefill()
    lgs = mesh.run(lambda c: vocab_logits(got[c][0], rules))
    torch.cuda.synchronize()
    ref = want[0].float().cpu().numpy()
    scale = float(np.abs(ref).max())
    worst_logit, worst_cache = 0.0, 0.0
    for c, (logits, caches, cur) in got.items():
        have = lgs[c].float().cpu().numpy()
        for b in range(len(ref)):
            err, ok = logits_close(have[b], ref[b], scale)
            if not ok:
                raise SystemExit(f"{name}: rank {c} row {b}'s last logits "
                                 f"differ by {err:.3g} from the unsharded "
                                 "prefill's")
            worst_logit = max(worst_logit, err)
        worst_cache = max(worst_cache, _tree_close(caches, want[1]))
        if cur != want[2]:
            raise SystemExit(f"{name}: cur_len {cur} != {want[2]}")
    if worst_cache > 2e-2:
        raise SystemExit(f"{name}: a cache differs from the unsharded "
                         f"prefill's by {worst_cache:.3g} of its max")
    del got, lgs, want
    ms = _host_ms(prefill, 3)
    one_ms = _host_ms(lambda: model.prefill(
        whole, padded, cache_len=path.cache_len, memory=memory), 3)
    mem_txt = "" if memory is None else \
        f", the encoder's {memory.shape[1]:,} frames in runs of " \
        f"{[b for _, b in rules.seq_slices('seq', memory.shape[1])]}"
    say(f"  {name}: {len(padded)} x {n} tokens in runs of {runs} a "
        f"rank{mem_txt}; last logits within rtol 2e-2, atol 2e-2 * "
        f"max|logits| of the unsharded prefill's on every rank (max "
        f"|difference| {worst_logit:.4g}, max |logit| {scale:.4g}), "
        f"caches within {worst_cache:.3g} of their max; {ms:.3f} ms "
        f"(host clock, median of 3) against {one_ms:.3f} unsharded; "
        f"{nvidia_smi_line()}")
    return {"prefill_ms": ms, "unsharded_prefill_ms": one_ms,
            "logit_err": worst_logit, "cache_rel_err": worst_cache}


def _tol_units(got, want, rtol: float = 1e-5) -> float:
    """max |got - want| / (rtol * max|want| + rtol * |want|): at most 1
    within rtol and atol ``rtol`` x max."""
    got, want = got.double(), want.double()
    atol = rtol * float(want.abs().max())
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def _slowed(params):
    """The tree with every rec block's ``lru_lambda`` spread over
    ``SP_SLOW_LAMBDA`` (the other leaves shared)."""
    def layer(lp):
        if "rec" not in lp:
            return lp
        lam = lp["rec"]["lru_lambda"]
        return dict(lp, rec=dict(lp["rec"], lru_lambda=torch.linspace(
            *SP_SLOW_LAMBDA, lam.numel(), dtype=lam.dtype,
            device=lam.device)))
    return dict(params, layers=[layer(lp) for lp in params["layers"]])


def carry_sp(cfg, whole, path: LMPath) -> dict:
    """The scan carry and the conv halo across the ranks, where they can
    be seen: recurrentgemma-2b's first rec block at full width in fp32
    (TF32 off) on 4 x 2,100 seeded positions, split over 2 and 4 model
    ranks (``fsdp_sp``; runs of 1,050 and 525), every position's output
    and the returned cache within rtol 1e-5, atol 1e-5 x max of the
    unsplit block's, with ``lru_lambda`` as drawn and slowed
    (``SP_SLOW_LAMBDA``); beside each, rank 1's run computed alone with
    its halo but from zero state (a dropped carry), and alone from zeros
    (a dropped carry and halo), in units of the same tolerance.  Then the
    whole slowed model's sequence-sharded prefill of ``path``'s prompts
    over 2 ranks with fp32 activations: the last logits and every cache
    (the local rings hold the last 2,048 positions of every attention
    layer) within rtol 1e-4, atol 1e-4 x max of the unsharded prefill's.
    (In bf16 the two prefills' roundings part where their sums run in
    another order, and 26 layers of slowed recurrence carry a flipped
    rounding along the sequence: a CPU probe at reduced width put the
    caches 6e-3 of max apart in bf16, 7e-7 in fp32.)"""
    from repro_torch.configs.base import PREFILL_32K
    from repro_torch.launch.specs import make_rules
    from repro_torch.models import build_model, rglru, transformer
    from repro_torch.models.transformer import vocab_logits
    from repro_torch.parallel.standin import StandInMesh
    from repro_torch.train.tree import leaves, tree_map

    B, S = 4, 2100
    gen = torch.Generator(device=DEVICE_TYPE).manual_seed(SEED)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=DEVICE_TYPE)
    drawn = tree_map(lambda t: t.float(), whole["layers"][0]["rec"])
    slow = _slowed({"layers": [{"rec": drawn}]})["layers"][0]["rec"]
    K = drawn["lru_conv"].shape[0]
    out = {}
    for label, p in (("as drawn", drawn), ("slowed", slow)):
        want, cache = rglru.rec_forward(p, x, cfg, return_cache=True)
        for R in SP_RANKS:
            mesh = StandInMesh((1, R), device_type=DEVICE_TYPE)
            rules = make_rules(cfg, mesh, PREFILL_32K)

            def rank(c):
                lo, m = rules.seq_slice("seq", S)
                return (lo, m) + rglru.rec_forward(
                    p, x[:, lo:lo + m], cfg, return_cache=True, rules=rules,
                    total=S)
            got = mesh.run(rank)
            joined = torch.cat([got[c][2] for c in sorted(got)], dim=1)
            err = _tol_units(joined, want)
            cache_err = max(max(_tol_units(g[3].h, cache.h),
                                _tol_units(g[3].conv, cache.conv))
                            for g in got.values())
            lo, m = got[(0, 1)][:2]
            no_carry = _tol_units(rglru.rec_forward(
                p, x[:, lo - (K - 1):lo + m], cfg)[0][:, K - 1:],
                want[:, lo:lo + m])
            neither = _tol_units(rglru.rec_forward(p, x[:, lo:lo + m],
                                                   cfg)[0],
                                 want[:, lo:lo + m])
            name = (f"recurrentgemma-2b's rec block, lru_lambda {label}, "
                    f"over {R} model ranks")
            if err > 1 or cache_err > 1:
                raise SystemExit(f"{name}: the split block's output lies "
                                 f"{err:.3g}, its cache {cache_err:.3g} "
                                 "tolerances from the unsplit block's")
            say(f"  {name}: {B} x {S:,} positions in runs of "
                f"{[b for _, b in rules.seq_slices('seq', S)]}, fp32; "
                f"every position's output {err:.3g} and the cache "
                f"{cache_err:.3g} of the tolerance (rtol 1e-5, atol 1e-5 x "
                f"max) from the unsplit block's; rank 1's run without the "
                f"carry would lie {no_carry:.3g}, without carry and halo "
                f"{neither:.3g} of it")
            out[f"{label} model={R}"] = {
                "of_tolerance": err, "cache_of_tolerance": cache_err,
                "without_carry": no_carry,
                "without_carry_or_halo": neither}
            del got, joined
        del want, cache
    del x
    torch.cuda.empty_cache()

    saved = transformer.ACT_DTYPE
    transformer.ACT_DTYPE = torch.float32   # outside mesh.run: shared
    try:
        slowed = _slowed(whole)
        model = build_model(cfg)
        _, padded = lm_prompts_of_path(cfg, path.prompt_lens)
        want = model.prefill(slowed, padded, cache_len=path.cache_len)
        mesh, rules, mine = _sp_ranks(cfg, slowed, (1, 2), PREFILL_32K)
        got = mesh.run(lambda c: model.prefill(
            mine[c], padded, cache_len=path.cache_len, rules=rules))
        lgs = mesh.run(lambda c: vocab_logits(got[c][0], rules))
        logit_err = max(_tol_units(v, want[0], 1e-4) for v in lgs.values())
        cache_err = max(_tol_units(a, b, 1e-4)
                        for g in got.values()
                        for a, b in zip(leaves(g[1]), leaves(want[1]))
                        if isinstance(a, torch.Tensor))
    finally:
        transformer.ACT_DTYPE = saved
    name = ("recurrentgemma-2b prefill_32k over 2 model ranks, lru_lambda "
            "slowed, fp32 activations")
    if logit_err > 1 or cache_err > 1:
        raise SystemExit(f"{name}: the last logits lie {logit_err:.3g}, a "
                         f"cache {cache_err:.3g} tolerances from the "
                         "unsharded prefill's")
    say(f"  {name}: {len(padded)} x {padded.shape[1]:,} tokens in runs of "
        f"{[b for _, b in rules.seq_slices('seq', padded.shape[1])]}; the "
        f"last logits {logit_err:.3g} and every cache {cache_err:.3g} of "
        f"the tolerance (rtol 1e-4, atol 1e-4 x max) from the unsharded "
        f"prefill's; {nvidia_smi_line()}")
    out["prefill fp32 slowed model=2"] = {"logits_of_tolerance": logit_err,
                                          "caches_of_tolerance": cache_err}
    del got, lgs, want, slowed, mine
    torch.cuda.empty_cache()
    return out


def phase_sp(trees: dict, goldens: dict, paths: dict) -> tuple[dict, dict]:
    """Phase 13: gemma3-1b at full width served under the decode cell's
    rules over 2 and 4 model ranks (``kv_seq`` on ``model``: its one KV
    head does not divide) and the long-context cell's over ``(2, 1)`` and
    ``(2, 2)`` (batch 1), its prefill cell's sequence-sharded prefill over
    2 and 4, one train step over 2 model ranks (``fsdp_sp``);
    recurrentgemma-2b's sequence-sharded prefill over 2 ranks (its 2,100
    positions in runs of 1,050: the window, the scan carry and the conv
    halo cross the ranks), the carry and halo where they can be seen
    (:func:`carry_sp`) and its golden under the decode cell's rules;
    whisper-tiny's prefill over 2 and 4 (the encoder's 1,500 frames in
    runs of 750 and 375) and its serving over 4 (``kv_seq`` on its self
    caches).  Returns the launch counts by path and the timings."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import DECODE_32K, LONG_500K
    from repro_torch.models import build_model, params_from_reference

    t0 = time.perf_counter()
    say("phase 13: sequence parallelism on the card: the ranks as threads "
        "of one process (StandInMesh); fsdp_sp (each rank a run of the "
        "positions), kv_seq (each rank a run of the global caches, the "
        "partial attentions combined by their log-sum-exp), long context")
    counts, timings = {}, {}
    by_name = {p.name: dataclasses.replace(p, max_new=SP_MAX_NEW)
               for p in LM_PATHS}

    cfg = get_config(LM)
    path = by_name[LM]
    whole = params_from_reference(cfg, trees[LM], DEVICE_TYPE)
    prompts, padded = lm_prompts_of_path(cfg, path.prompt_lens)
    want = unsharded_serve(cfg, whole, path, prompts, padded, None)
    for R in SP_RANKS:
        key = f"{LM} decode_32k model={R}"
        counts[key], timings[key] = serve_sp(cfg, whole, goldens[LM], path,
                                             (1, R), DECODE_32K, want,
                                             paths.get(f"{LM} serve"))
    for R in SP_RANKS:
        timings[f"{LM} prefill_32k model={R}"] = prefill_sp(cfg, whole, path,
                                                            R)
    long_path = dataclasses.replace(path, prompt_lens=path.prompt_lens[-1:])
    lp, lpad = lm_prompts_of_path(cfg, long_path.prompt_lens)
    want = unsharded_serve(cfg, whole, long_path, lp, lpad, None)
    for shape in SP_LONG_SHAPES:
        key = f"{LM} long_500k {shape}"
        counts[key], timings[key] = serve_sp(cfg, whole, None, long_path,
                                             shape, LONG_500K, want,
                                             paths.get(f"{LM} serve"))
    del whole, want
    torch.cuda.empty_cache()
    timings[f"{LM} train model=2"] = train_tp(cfg, trees[LM], 2,
                                              label="phase 13")

    name = "recurrentgemma-2b"
    cfg, path = get_config(name), by_name[name]
    whole = params_from_reference(cfg, trees[name], DEVICE_TYPE)
    timings[f"{name} prefill_32k model=2"] = prefill_sp(cfg, whole, path, 2)
    timings[f"{name} carry"] = carry_sp(cfg, whole, path)
    mesh, rules, mine = _sp_ranks(cfg, whole, (1, 2), DECODE_32K)
    held = mesh.run(lambda c: golden_rows(build_model(cfg), mine[c],
                                          goldens[name], rules))
    if any(rows != _first(held)[1] or not h["ok"]
           for h, rows in held.values()):
        raise SystemExit(f"{name} decode_32k over 2 model ranks: the "
                         f"ranks' golden checks differ or fail: {held}")
    hold_golden(f"{name} decode_32k over 2 model ranks, every rank", cfg,
                *_first(held), goldens[name])
    del whole, mesh, rules, mine
    torch.cuda.empty_cache()

    name = "whisper-tiny"
    cfg, path = get_config(name), by_name[name]
    whole = params_from_reference(cfg, trees[name], DEVICE_TYPE)
    for R in SP_RANKS:
        timings[f"{name} prefill_32k model={R}"] = prefill_sp(cfg, whole,
                                                              path, R)
    prompts, padded = lm_prompts_of_path(cfg, path.prompt_lens)
    memory = lm_memory_of_path(cfg, len(prompts))
    want = unsharded_serve(cfg, whole, path, prompts, padded, memory)
    key = f"{name} decode_32k model=4"
    counts[key], timings[key] = serve_sp(cfg, whole, goldens[name], path,
                                         (1, 4), DECODE_32K, want,
                                         paths.get(f"{name} serve"))
    del whole, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say(f"  phase 13 took {time.perf_counter() - t0:.1f} s")
    return counts, timings


# ---------------------------------------------------------------------------
# Phase 5: the port's compile pipeline, then the card runs its plans.
# ---------------------------------------------------------------------------

def _compile_timed(*args, **kwargs):
    """``repro_torch.compile(*args, **kwargs)``, with its wall seconds
    and each pass's, on the host; the static verifier's schedule cache is
    emptied first, so a static proof is timed as in a fresh process."""
    import repro_torch
    from repro_torch.analysis import verifier

    verifier._SCHED_CACHE.clear()
    t0 = time.perf_counter()
    cn = repro_torch.compile(*args, **kwargs)
    total = time.perf_counter() - t0
    return cn, {"total_s": total, "passes": {p.name: p.seconds
                                             for p in cn.passes}}


def _same_plan(label: str, cn, payload: dict) -> None:
    """The compiled program, certificate and ``mcu`` summary equal the
    committed artifact's."""
    from repro_torch.compile.artifact import program_sha256

    for key, have in (("program", cn.program.to_json_dict()),
                      ("certificate", cn.certificate), ("mcu", cn.mcu)):
        if have != payload[key]:
            raise SystemExit(f"{label}: the compiled {key} differs from the "
                             "committed artifact's")
    say(f"  {label}: program ({len(cn.program.ops)} ops, sha256 "
        f"{program_sha256(cn.program)[:12]}...), certificate and mcu equal "
        "the committed artifact's")


def _same_counts(label: str, counts, want) -> None:
    if {k: n for k, n in counts.items() if n} \
            != {k: n for k, n in want.items() if n}:
        raise SystemExit(f"{label}: launches {counts} differ from phase "
                         f"3's {want}")


def path_compiled_int8(counts3, goldens, certify,
                       suffix) -> tuple[dict, dict, object]:
    """DS-CNN int8 compiled by the port from the reference's params and
    calibration inputs (certified by ``certify``), then run on the
    card."""
    from repro_torch.compile import artifact as art
    from repro_torch.core.executors import run_program
    from repro_torch.graph.run import quantize_ops
    from repro_torch.quant.qtensor import QParams, quantize

    name = "ds-cnn"
    label = name + suffix
    params, calib = art.read_compile_inputs(
        ASSETS / f"{name}.cortex-m4.int8.compile.npz")
    payload = art.load(artifact(name))
    cn, timing = _compile_timed(name, "cortex-m4", params=params,
                                calib=calib, certify=certify)
    _same_plan(label, cn, payload)
    want_scales = np.asarray(payload["quant"]["act_scales"])
    rel = float((np.abs(np.asarray(cn.qnet.act_scales) - want_scales)
                 / want_scales).max())
    if rel > SCALE_RTOL:
        raise SystemExit(f"{label}: activation scales differ from the "
                         f"artifact's by {rel:.3g} > rtol {SCALE_RTOL}")
    q = quantize_ops(cn.program, params, tuple(want_scales.tolist()))
    want_q = art.decode(payload["quant"]["qparams"])
    flat = [(a, b) for qa, qb in zip(q, want_q) for a, b in zip(qa, qb)]
    if len(q) != len(want_q) or not all(
            type(a) is type(b) and np.array_equal(a, b)
            and np.asarray(a).dtype == np.asarray(b).dtype for a, b in flat):
        raise SystemExit(f"{label}: quantize_ops on the artifact's scales "
                         "differs from its qparams")
    golden = goldens[name]
    x = torch.from_numpy(golden["x"]).cuda()
    out = {}

    def drive():
        out["batch"] = cn.run(x)
        out["single"] = [cn.run(xi) for xi in x]

    counts = _counted(f"{label} run", cn, 2 * len(x), "inference", drive)
    _same_counts(label, counts, counts3[name])
    y = out["batch"]
    if y.device.type != DEVICE_TYPE or not all(
            torch.equal(yi, y[i]) for i, yi in enumerate(out["single"])):
        raise SystemExit(f"{label}: outputs left the card or single runs "
                         "differ from the batch")
    y_cpu = cn.run(golden["x"], device="cpu")
    if not torch.equal(y.cpu(), y_cpu):
        raise SystemExit(f"{label}: float outputs on the card differ from "
                         "the plain CPU path")
    qparams_card = art.to_device(cn.qnet.qparams, x.device)
    qparams_cpu = art.to_device(cn.qnet.qparams, "cpu")
    kbr = cn.target.kernel_block_rows
    steps = 0
    for i, xi in enumerate(x):
        xq = quantize(xi, QParams(scale=cn.qnet.in_scale))
        yq, _ = run_program(cn.program, xq, qparams_card,
                            kernel_block_rows=kbr)
        yq_cpu, _ = run_program(cn.program, xq.cpu(), qparams_cpu,
                                kernel_block_rows=kbr)
        if not torch.equal(yq.cpu(), yq_cpu):
            raise SystemExit(f"{label}: int8 output {i} on the card differs "
                             "from the plain CPU path")
        steps = max(steps, int(np.abs(yq_cpu.numpy().astype(np.int64)
                                      - golden["y_q"][i]).max()))
    err = float(np.abs(y.cpu().numpy() - golden["y"]).max())
    step = cn.qnet.out_scale
    if steps > COMPILED_INT8_STEPS \
            or err > COMPILED_INT8_STEPS * step * (1 + 1e-4):
        raise SystemExit(f"{label}: outputs lie {err:.4g} ({steps} int8 "
                         f"steps) from the golden, beyond "
                         f"{COMPILED_INT8_STEPS} step of {step:.4g}")
    say(f"  {label}: activation scales within {rel:.3g} of the artifact's "
        f"(rtol {SCALE_RTOL}); quantize_ops on its scales equals its "
        f"qparams bitwise; run on the card equals the plain CPU path "
        f"bitwise on all {len(x)}, {err:.4g} ({steps} int8 step) from the "
        f"golden (one step {step:.4g})")
    timing.update(max_scale_rel=rel, golden_max_abs=err, golden_steps=steps)
    return counts, timing, cn


def compile_and_run(counts3, goldens, certify: str,
                    suffix: str) -> tuple[dict, dict, dict]:
    """The port compiles phase 5's three plans on the host, certified by
    ``certify``, and the card runs them.  Returns each compiled path's
    launch counts, timings and net, by label (the phase-3 label and
    ``suffix``)."""
    from repro_torch.compile import artifact as art

    counts, timings, nets = {}, {}, {}
    label = "ds-cnn" + suffix
    counts[label], timings[label], nets[label] = path_compiled_int8(
        counts3, goldens, certify, suffix)

    name = "mcunet-5fps-vww" + F32
    label = name + suffix
    payload = art.load(artifact(name))
    nets[label], timings[label] = _compile_timed(
        "mcunet-5fps-vww", "host-sim", certify=certify,
        params=art.decode(payload["params"]))
    _same_plan(label, nets[label], payload)
    counts[label] = path_serve_f32(label, nets[label], goldens[name])
    _same_counts(label, counts[label], counts3[name])

    name = "ds-cnn-stream" + F32
    label = name + suffix
    payload = art.load(artifact(name))
    nets[label], timings[label] = _compile_timed(
        "ds-cnn", "host-sim", streaming=True, certify=certify,
        params=art.decode(payload["params"]))
    _same_plan(label, nets[label], payload)
    counts[label] = path_stream_f32(label, nets[label], goldens[name])
    _same_counts(label, counts[label], counts3[name])

    say(f"  compile seconds, host CPU time on the card's machine "
        f"({nvidia_smi_line()}):")
    for label, t in timings.items():
        say(f"    {label}: {t['total_s']:.4f} s in all; "
            + ", ".join(f"{n} {sec:.4f}" for n, sec in t["passes"].items()))
    return counts, timings, nets


# ---------------------------------------------------------------------------
# Phase 6: the static proof, lint and C on the host, then the card.
# ---------------------------------------------------------------------------

def verify_assets() -> dict:
    """(a) Every committed plan proven safe with the certificate it
    stores, and linted clean; the proof timed with the verifier's
    schedule cache empty (as in a fresh process), then warm."""
    from repro_torch.analysis import lint_artifact, verifier, verify_program
    from repro_torch.compile import artifact as art
    from repro_torch.core.program import PoolProgram

    out = {}
    for path in sorted(ASSETS.glob("*.json")):
        payload = art.load(path)
        program = PoolProgram.from_json_dict(payload["program"])
        verifier._SCHED_CACHE.clear()
        t0 = time.perf_counter()
        res = verify_program(program)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        verify_program(program)
        warm = time.perf_counter() - t0
        cert = payload["certificate"]
        if res.safe is not True \
                or res.certificate(cert["program_sha256"]) != cert:
            raise SystemExit(f"{path.name}: the static proof gives "
                             f"{res.safe} {res.diagnostics[:1]}, not the "
                             "artifact's certificate")
        t0 = time.perf_counter()
        rep = lint_artifact(str(path))
        lint_s = time.perf_counter() - t0
        if not rep.clean or rep.result.safe is not True:
            raise SystemExit(f"{path.name}: lint is not clean: "
                             f"{[str(d) for d in rep.result.diagnostics]}")
        out[path.stem] = {"ops": len(program.ops), "verify_cold_s": cold,
                          "verify_warm_s": warm, "lint_s": lint_s}
        say(f"  {path.stem}: proven safe, certificate equal to the "
            f"artifact's, lint clean ({len(program.ops)} ops; verify "
            f"{cold:.5f} s cold, {warm:.5f} s warm; lint {lint_s:.5f} s)")
    return out


def golden_units() -> dict:
    """(c) VWW's and ResNet-8's ring-geometry C equal to the goldens."""
    import repro_torch

    out = {}
    for net, name in (("mcunet-5fps-vww", "vww"), ("resnet-8", "resnet8")):
        t0 = time.perf_counter()
        cn = repro_torch.compile(net, "cortex-m4", quantize=False,
                                 certify=False)
        units = cn.emit_c(geometry_only=True, name=name)
        secs = time.perf_counter() - t0
        golden = ROOT / "tests" / "golden" / name
        want = {p.name: p.read_text() for p in golden.glob("*.c")}
        if units != want:
            bad = sorted(n for n in set(units) | set(want)
                         if units.get(n) != want.get(n))
            raise SystemExit(f"{name}: emitted C differs from "
                             f"tests/golden/{name}/ in {bad}")
        out[name] = {"units": len(units), "compile_and_emit_s": secs}
        say(f"  {name}: {len(units)} geometry-only units byte-identical to "
            f"tests/golden/{name}/ ({secs:.4f} s to compile and emit)")
    return out


def cli_smokes() -> dict:
    """(d) Both command lines' ``--smoke`` as subprocesses, on a host with
    no JAX."""
    import os

    out = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for module in ("repro_torch.cli", "repro_torch.analysis.cli"):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", module, "--smoke"],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        secs = time.perf_counter() - t0
        if run.returncode != 0:
            raise SystemExit(f"python -m {module} --smoke exited "
                             f"{run.returncode}: {run.stderr[-2000:]}")
        last = run.stdout.strip().splitlines()[-1]
        out[module] = {"rc": run.returncode, "s": secs, "last": last}
        say(f"  python -m {module} --smoke: exit 0 in {secs:.2f} s "
            f"({last!r})")
    return out


def phase_static(counts3, goldens, sim_nets, sim_timings):
    """Phase 6: the static proof, lint, C and both command lines on the
    host, then phase 5's three plans compiled with ``certify="static"``
    and run on the card.  Returns the compiled paths' launch counts and
    the ``verify`` record."""
    say("phase 6: the static verifier, lint and codegen on the host, then "
        "the card runs the statically certified plans")
    record = {"assets": verify_assets()}
    counts, timings, nets = compile_and_run(counts3, goldens, "static",
                                            COMPILED + STATIC)
    certify = {}
    for label, cn in nets.items():
        sim_label = label[:-len(STATIC)]
        note = next(p.note for p in cn.passes if p.name == "certify")
        if not note.startswith("static proof"):
            raise SystemExit(f"{label}: the certify pass fell back: {note}")
        if cn.certificate != sim_nets[sim_label].certificate:
            raise SystemExit(f"{label}: the static certificate differs from "
                             "phase 5's sim certificate")
        certify[sim_label] = {
            "static_s": timings[label]["passes"]["certify"],
            "sim_s": sim_timings[sim_label]["passes"]["certify"],
            "static_total_s": timings[label]["total_s"],
            "sim_total_s": sim_timings[sim_label]["total_s"]}
    say(f"  certify seconds, host CPU time on the card's machine "
        f"({nvidia_smi_line()}):")
    for label, t in certify.items():
        say(f"    {label}: static {t['static_s']:.5f} s, sim "
            f"{t['sim_s']:.5f} s")
    record["certify"] = certify
    record["golden_c"] = golden_units()
    record["cli"] = cli_smokes()
    return counts, record


# ---------------------------------------------------------------------------
# Phase 2's window reads, phase 7 (partial execution on the host) and
# phase 8 (traces on the card).
# ---------------------------------------------------------------------------

#: A phase-8 path's label: its phase-3 twin's, with this suffix.
TRACED = "-traced"
#: The paths phase 8 traces (their phase-3 labels).
TRACED_PATHS = ("ds-cnn", "mcunet-5fps-vww" + F32, SLICED)
#: CI's partial-execution smoke, run by the port's command line.
CI_PARTIAL = ("mcunet-320kb-imagenet", "--target", "cortex-m7", "--dtype",
              "int8", "--partial", "auto", "--no-quantize", "--certify",
              "static")


def window_ops(cn) -> list[str]:
    """Each op of ``cn`` that reads a window of a held source
    (``in_row0``): its base (the source's pointer advanced ``in_row0``
    image rows; the kernel takes it modulo the ring), its CTAs and its
    mode, and the shared record it writes into."""
    from repro_torch.core.executors import op_kernel_call
    from repro_torch.kernels.conv2d import conv_tiling

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    prog = cn.program
    lines = []
    for i, (op, p) in enumerate(zip(prog.ops, params_of(cn))):
        if not op.in_row0:
            continue
        name, _, kw = op_kernel_call(
            prog, op, p, kernel_block_rows=cn.target.kernel_block_rows)
        t = conv_tiling(name, kw, n_sm)
        base = kw["in_ptr"]
        lines.append(f"op {i} {name}: rows {op.in_row0}.."
                     f"{op.in_row0 + op.h_in} of {op.h_src}, base {base}"
                     + (f" (past the ring: {base % prog.n_segments})"
                        if base >= prog.n_segments else "")
                     + f", {t.ctas} CTAs, read first under a grid barrier"
                     + (f", into op {op.out_op}'s record at row "
                        f"{op.out_row0}" if op.out_op >= 0 else ""))
    return lines


def phase_partial() -> dict:
    """Phase 7: the port's partial pass on the card machine's host — the
    sliced ImageNet compile equal to the committed asset's plan, then CI's
    partial smoke through the port's command line."""
    import os

    from repro_torch.compile import artifact as art

    say("phase 7: partial execution, compiled on the card machine's host")
    payload = art.load(artifact(SLICED))
    cn, timing = _compile_timed("mcunet-320kb-imagenet", "cortex-m4",
                                partial="auto", quantize=False,
                                certify="static")
    for key, have in (("program", cn.program.to_json_dict()),
                      ("partial", cn.partial),
                      ("certificate", cn.certificate), ("mcu", cn.mcu)):
        if have != payload[key]:
            raise SystemExit(f"phase 7: the compiled {key} differs from the "
                             "sliced asset's")
    if cn.certificate["clobbers"] != 0:
        raise SystemExit("phase 7: the sliced plan's certificate shows "
                         "clobbers")
    s = cn.partial
    say(f"  mcunet-320kb-imagenet cortex-m4 partial='auto': "
        f"{s['n_sliced_groups']} groups, {s['total_slices']} slices, ring "
        f"{s['ring_bytes_before']} -> {s['ring_bytes_after']} B, "
        f"+{s['mac_overhead']:.4%} MACs, {len(cn.program.ops)} ops; "
        "program, partial summary, certificate (0 clobbers) and mcu equal "
        "the sliced asset's")
    say(f"  compile seconds, host CPU time ({nvidia_smi_line()}): "
        f"{timing['total_s']:.4f} s in all; "
        + ", ".join(f"{n} {sec:.4f}" for n, sec in timing["passes"].items()))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.cli",
                          *CI_PARTIAL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise SystemExit(f"python -m repro_torch.cli {' '.join(CI_PARTIAL)} "
                         f"exited {run.returncode}: {run.stderr[-2000:]}")
    say(f"  python -m repro_torch.cli {' '.join(CI_PARTIAL)}: exit 0 in "
        f"{secs:.2f} s")
    return {"compile": timing, "summary": {k: v for k, v in s.items()
                                           if k not in ("parents", "groups")},
            "cli_s": secs}


def _trace_path(label: str, cn, x, paths) -> tuple[dict, dict]:
    """``run(x, trace=True)`` on the card against the untraced run, the
    certificate, the ring and the CPU's trace."""
    y = cn.run(x)
    out = {}
    counts = _counted(f"{label} traced run", cn, 1, "inference",
                      lambda: out.update(r=cn.run(x, trace=True)))
    y_t, art = out["r"]
    if not torch.equal(y_t, y):
        raise SystemExit(f"{label}: the traced output differs from the "
                         "untraced one")
    prog, cert = cn.program, cn.certificate
    seg_bytes = prog.seg_width * prog.elem_bytes
    t = art.totals
    if (t["bytes_loaded"], t["bytes_stored"]) != \
            (cert["reads"] * seg_bytes, cert["writes"] * seg_bytes):
        raise SystemExit(f"{label}: traced traffic {t['bytes_loaded']} / "
                         f"{t['bytes_stored']} B is not the certificate's")
    if art.watermark_bytes != prog.pool_bytes \
            or art.backend != DEVICE_TYPE:
        raise SystemExit(f"{label}: watermark {art.watermark_bytes} B, "
                         f"backend {art.backend}")
    _, cpu = cn.run(x.cpu(), device="cpu", trace=True)
    if dict(art.canonical(), backend=None) != \
            dict(cpu.canonical(), backend=None):
        raise SystemExit(f"{label}: the card's trace differs from the CPU's")
    walls = [e["wall_us"] for e in art.events
             if 0 <= e["index"] < len(prog.ops)]
    if len(walls) != len(prog.ops) or min(walls) <= 0:
        raise SystemExit(f"{label}: an op has no wall time")
    p = paths[label]
    card_us = None if p["device_busy"] is None \
        else p["device_busy"] * p["call_us"]
    say(f"  {label}: traced output bitwise the untraced one; "
        f"{t['bytes_loaded']} B loaded / {t['bytes_stored']} B stored = the "
        f"certificate's {cert['reads']} reads / {cert['writes']} writes x "
        f"{seg_bytes} B; watermark {art.watermark_bytes} B = pool_bytes; "
        f"canonical trace = the CPU's; {len(walls)} ops' wall_us sum "
        f"{sum(walls):.1f} us (min {min(walls):.2f}, max {max(walls):.2f}) "
        f"against phase 4's "
        + ("card time not measured" if card_us is None else
           f"{card_us:.1f} us of card time")
        + f" and {p['latency_ms'] * 1e3:.1f} us latency per inference")
    return counts, {"wall_us_sum": sum(walls), "wall_us_min": min(walls),
                    "wall_us_max": max(walls), "phase4_card_us": card_us,
                    "phase4_latency_ms": p["latency_ms"],
                    "bytes_loaded": t["bytes_loaded"],
                    "bytes_stored": t["bytes_stored"]}


def phase_traces(plans, goldens, paths) -> tuple[dict, dict]:
    """Phase 8: ``run(x, trace=True)`` on three paths, a traced stream,
    and the trace command line's smoke.  Returns the traced runs' launch
    counts and the record."""
    import os
    import tempfile

    say("phase 8: traces on the card (CUDA events around each op's launch, "
        "one synchronize after the last)")
    counts, record = {}, {}
    for label in TRACED_PATHS:
        x = torch.from_numpy(goldens[label]["x"][0]).cuda()
        counts[label + TRACED], record[label] = _trace_path(
            label, plans[label], x, paths)

    name = "ds-cnn-stream"
    cn, golden = plans[name], goldens[name]
    cert = cn.certificate
    state = cert["state_segments"]
    frames = torch.from_numpy(golden["x_q"]).cuda()
    session, sim = cn.stream(trace=True), cn.stream(backend="sim")
    ys = []
    counts[name + TRACED] = _counted(
        f"{name} traced stream", cn, len(frames), "step",
        lambda: ys.extend(session.step(f) for f in frames))
    for i, y in enumerate(ys):
        if not np.array_equal(y.cpu().numpy(), golden["y_q"][i]):
            raise SystemExit(f"{name}: traced step {i} differs from the "
                             "golden")
    reads, writes = 0, state
    for k, art in enumerate(session.traces, start=1):
        c = sim.step()
        reads += art.totals["segs_read"] + 2 * state
        writes += art.totals["segs_written"] + state
        want = (k * cert["reads"], state + k * (cert["writes"] - state))
        if (reads, writes) != want or (c["reads"], c["writes"]) != want:
            raise SystemExit(f"{name}: counters after {k} traced steps "
                             f"{(reads, writes)} (the sim's {c['reads']}, "
                             f"{c['writes']}) are not init + k*step {want}")
    walls = [a.totals["wall_us"] for a in session.traces]
    say(f"  {name}: {len(ys)} traced steps, every int8 output equal the "
        f"golden; counters after {len(ys)} steps = init + N*step = "
        f"({reads} reads, {writes} writes), as the sim oracle counts; "
        f"wall_us a step median {statistics.median(walls):.1f}")
    record[name] = {"steps": len(ys), "reads": reads, "writes": writes,
                    "wall_us_median": statistics.median(walls)}

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "repro_torch.obs.cli",
                              "--smoke"], cwd=tmp, env=env,
                             capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise SystemExit(f"python -m repro_torch.obs.cli --smoke exited "
                         f"{run.returncode}: {run.stderr[-2000:]}")
    last = run.stdout.strip().splitlines()[-1]
    say(f"  python -m repro_torch.obs.cli --smoke: exit 0 in {secs:.2f} s "
        f"in a temporary directory ({last!r})")
    record["obs_smoke_s"] = secs
    return counts, record


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py runs from the root of a checkout "
                         "that holds src/repro_torch")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is "
                         "available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.cases import (CARD_EDGE_CASES, EDGE_CASES,
                                           F32_EDGE_CASES,
                                           F32_FUSED_STREAM_EDGE_CASES,
                                           F32_MLP_EDGE_CASES,
                                           LM_DECODE_CASES,
                                           SLICE_DECODE_CASES)

    card = nvidia_smi_line()
    say(f"phase 0: card {card}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    # fp32 products and convolutions of the plain versions, of
    # reference_forward and of the library calls run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    draws = start_lm_draws([p.name for p in LM_PATHS])
    phase_build()

    served_labels = NETS + tuple(n + F32 for n in FLOAT_NETS
                                 + SEEDED_FLOAT_NETS)
    stream_labels = STREAMS + tuple(n + F32 for n in FLOAT_STREAMS)
    labels = served_labels + stream_labels
    plans = {n: load_plan(n) for n in labels}
    goldens = {n: load_golden(n, plans[n]) for n in labels}
    cases = {n: plan_cases(n, cn) for n, cn in plans.items()}
    errs = phase_parity(EDGE_CASES + CARD_EDGE_CASES + F32_EDGE_CASES
                        + F32_FUSED_STREAM_EDGE_CASES + F32_MLP_EDGE_CASES
                        + sum(cases.values(), ()))
    say(f"  {SLICED}'s window reads (base, CTAs, mode):")
    for line in window_ops(plans[SLICED]):
        say(f"    {line}")
    decode_err = phase_decode_parity()

    say("phase 3: the paths on the card")
    counts = {}
    for n in NETS:
        counts[n] = path_serve(n, plans[n], goldens[n])
    for n in FLOAT_NETS + SEEDED_FLOAT_NETS:
        counts[n + F32] = path_serve_f32(n + F32, plans[n + F32],
                                         goldens[n + F32])
    for n in STREAMS:
        counts[n] = path_stream(n, plans[n], goldens[n])
    for n in FLOAT_STREAMS:
        counts[n + F32] = path_stream_f32(n + F32, plans[n + F32],
                                          goldens[n + F32])
    lm_cfg, lm_weights, lm_tree = lm_setup(LM, draws, keep_tree=True)
    with np.load(ASSETS / f"{LM}.golden.npz") as g:
        lm_golden = {k: g[k] for k in g.files}
    counts[LM] = path_lm(lm_cfg, lm_weights, lm_golden)

    served = []
    for n in served_labels:
        x1 = torch.from_numpy(goldens[n]["x"][0]).cuda()
        served.append((n, plans[n],
                       lambda cn=plans[n], x1=x1: cn.run(x1), "inference"))
    streamed = []
    for n in stream_labels:
        session = plans[n].stream()
        first = goldens[n]["x_q" if plans[n].quantized else "x"][0]
        frame = torch.from_numpy(first).cuda()
        streamed.append((n, plans[n],
                         lambda s=session, f=frame: s.step(f), "step"))
    rows, paths = phase_timing(served, streamed, cases, counts, errs,
                               goldens)
    tower = cases[SEEDED_FLOAT_NETS[0] + F32][0]
    next(r for r in rows if r["name"] == "ring_fused_mlp")["by_tiling"] = \
        time_mlp_tilings(tower)
    next(r for r in rows if r["name"] == "ring_add_q")["by_mode"] = \
        time_add_modes(cases["resnet-8"] + cases["mcunet-5fps-vww"]
                       + EDGE_CASES + CARD_EDGE_CASES)
    next(r for r in rows if r["name"] == "ring_gemm_q")["by_mode"] = \
        time_gemm_modes(sum((cases[n] for n in NETS + STREAMS[:1]), ())
                        + EDGE_CASES)
    next(r for r in rows if r["name"] == "ring_gru_cell_q")["by_mode"] = \
        time_gru_modes(cases[STREAMS[1]] + EDGE_CASES, "ring_gru_cell_q")
    next(r for r in rows if r["name"] == "ring_gru_cell")["by_mode"] = \
        time_gru_modes(cases[STREAMS[1] + F32] + F32_FUSED_STREAM_EDGE_CASES,
                       "ring_gru_cell")
    paths[f"{LM} serve"] = time_lm(lm_cfg, lm_weights)
    decode_row = time_decode_kernel(
        lm_cfg, max(LM_PROMPT_LENS) + LM_MAX_NEW // 2, counts[LM],
        decode_err)
    rows.append(decode_row)
    del lm_weights
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    say("phases 3 and 4, the LMs of the other block kinds at full width, "
        "one resident at a time: served and held (phase 3), then timed "
        "(phase 4)")
    lm_counts, lm_timings, tp_trees = serve_new_lms(ASSETS, draws)
    counts.update(lm_counts)
    paths.update(lm_timings)
    decode_row["launches"] += sum(c["ring_decode_attention"]
                                  for c in lm_counts.values())
    decode_row["launches_by_path"] = {
        p.name: counts[p.name]["ring_decode_attention"] for p in LM_PATHS}
    say("  ring_decode_attention at those paths' decode geometries:")
    decode_row["by_shape"].update(time_decode_shapes(LM_DECODE_CASES))
    say("  ring_decode_attention with return_lse on a rank's slice of "
        "gemma3-1b's global cache and whisper-tiny's self caches (phase "
        "13's kv_seq paths):")
    decode_row["by_shape"].update(time_decode_shapes(
        [c for c in SLICE_DECODE_CASES if isinstance(c.seq_len, int)],
        lse=True))

    with np.load(ASSETS / f"{LM}.train.npz") as g:
        train_golden = {k: g[k] for k in g.files}
    train_counts, paths[f"{LM} train"] = phase_train(lm_cfg, lm_tree,
                                                     train_golden)
    decode_row["launches"] += train_counts["ring_decode_attention"]
    decode_row["launches_by_path"][f"{LM} trained"] = \
        train_counts["ring_decode_attention"]
    mesh_counts, paths[f"{LM} mesh"] = phase_mesh(
        lm_cfg, lm_tree, lm_golden, train_golden, paths[f"{LM} serve"])
    decode_row["launches"] += mesh_counts["ring_decode_attention"]
    decode_row["launches_by_path"][f"{LM} mesh"] = \
        mesh_counts["ring_decode_attention"]
    paths["mesh gloo"] = phase_gloo()
    tp_counts, tp_timings = phase_tp(tp_trees, paths)
    paths.update({f"{k} tp": v for k, v in tp_timings.items()})
    sp_goldens = {}
    for name in (LM,) + SP_SERVED:
        with np.load(ASSETS / f"{name}.golden.npz") as g:
            sp_goldens[name] = {k: g[k] for k in g.files}
    sp_counts, sp_timings = phase_sp(
        {LM: lm_tree, **{n: tp_trees[n] for n in SP_SERVED}}, sp_goldens,
        paths)
    del tp_trees, lm_tree
    paths.update({f"{k} sp": v for k, v in sp_timings.items()})
    for key, c in {**tp_counts, **sp_counts}.items():
        decode_row["launches"] += c["ring_decode_attention"]
        decode_row["launches_by_path"][f"{key} (all ranks)"] = \
            c["ring_decode_attention"]

    say("phase 5: repro_torch.compile on the host, then the card runs the "
        "plans it compiled")
    compiled, compile_timings, compiled_nets = compile_and_run(
        counts, goldens, "sim", COMPILED)
    static, verify_record = phase_static(counts, goldens, compiled_nets,
                                         compile_timings)
    partial_record = phase_partial()
    traced, trace_record = phase_traces(plans, goldens, paths)
    for row in rows:
        for counted in (compiled, static, traced):
            row["launches"] += sum(c[row["name"]] for c in counted.values())

    say(json.dumps({"paths": paths}))
    say(json.dumps({"compile": compile_timings}))
    say(json.dumps({"verify": verify_record}))
    say(json.dumps({"partial": partial_record}))
    say(json.dumps({"traces": trace_record}))
    say(json.dumps({"kernels": rows}))
    say(nvidia_smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
