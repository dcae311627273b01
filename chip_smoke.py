#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--size 256] [--seed 0]

Phases, each printing one JSON line (any failure exits non-zero):

1. device   : the card's name, count and power limit.
2. build    : nvcc of every ``src/repro_torch/csrc/*.cu`` for sm_90a, in
              parallel, with ptxas' registers and spills per kernel (parsed
              for every K3 and K5 instantiation, build_plan_kernel and the
              two contraction kernels).
3. kernels  : each kernel against its plain PyTorch version on the same
              inputs at size^3 (the matvec's contractions, bit for bit, at
              size^3 and nt = 4, at nt = 1, 6 and 12 on 32^3, on an odd grid
              and with a misaligned adjoint field; the plan build, bit for bit, for every
              basis and weight type at the footpoints of a smooth size^3
              velocity, the cubic B-spline on the slab path's clamped
              (size+12) x size^2 field and at the footpoints of 64^3 and
              128^3 velocities, the multires coarse levels, and at every
              query set below; K1 FD8 per axis and the prefilter on K=2 and
              K=3 stacks, then both modes on every axis of the stacks in
              K1_EDGE_SHAPES, where its tiling is awkward; K5 on a
              (size+8)-row halo-extended field and on a 5-field stack of
              size/4+8 rows, the one-rank and 4-slab
              shapes, and on every axis of the K=3 stacks of K5_EDGE (n_loc
              2 < R, part chunks, the scalar rows path); K3 with both
              epilogues, fp32 and bf16, on a cubic plan from the footpoints
              of a smooth velocity and on the slab path's plan (a field
              with 2 x 6 halo rows on x1, gathered at its size^3 interior);
              K2 and K4 for
              each basis, fp32 and bf16 weights, K=1, 2 and 3, and K3 for
              each basis (S = 4 and 2), both weight types and epilogues, at
              each query
              set of ``k24_query_sets`` (those footpoints, shifted by -3 and
              across the periodic seam, uniform over the grid, on 5^3 and
              16x24x40 fields, as a 1D output), and the share of K4's cubic
              blocks that staged their shared-memory source box per set
              (>= 0.9 at the footpoints, 0 at uniform queries); K6 flash
              attention at (a) BH 128, S 2048, hd 64,
              bf16, both flags; (b) BH 16, S 1000, hd 64, fp32, both flags;
              (c) BH 28, S 1024, hd 128, bf16, causal; (d) BH 16, S 16384,
              hd 64, bf16, causal, the plain version per head; and at the
              prefill shape of every LM path below, B * n_heads x prompt x
              head_dim, causal (whisper: the encoder's non-causal at 1500
              frames and the decoder's at 187 tokens; mamba2 has none); and
              bf16 at K6_EDGE: S = 1, 37, 64, 2000,
              4097, hd 64 and 128, both flags; and with a query offset at
              K6_OFFSET, smollm-135m's sequence-parallel prefill on a model
              axis of 4: a rank's 512 query rows at offsets 0 / 512 / 1024 /
              1536 of 2048 keys, BH 72, hd 64, fp32 and bf16, causal). Two
              faulty plain versions at
              (a), P rounded to bf16 before P.V and the last key tile
              dropped, must fail
              K6's bf16 check, so that the check can see such faults.
4. reference: 16^3 registrations on the card (fused plan path; plan-free;
              NCC and NGF, the latter capped at REF_NGF_MAX_NEWTON steps, on
              the contrast-inverted pair; a B = 2 register_batch with the
              donating step) against the same registrations through the
              plain versions on the CPU: equal Newton and PCG counts (per
              pair); then (reference_lm) the
              smoke config of every LM family (qwen1.5-0.5b, smollm-135m,
              deepseek-moe-16b, mamba2-780m, jamba-v0.1-52b,
              whisper-large-v3, internvl2-1b) with K6's head size 64, fp32
              and bf16, the same seeded weights and batch on the card and
              on the CPU: prefill and decode logits within the CPU tests'
              tolerances (bf16: equal prefill argmax), equal greedy ids and
              equal MoE routing (top indices, capacity keep masks) in fp32,
              K6 once per self-attention layer and no plain version.
5. matvec   : the plan-path and the fused (K3) Gauss-Newton matvec on one
              size^3 GradientState, <= 1e-5 * max(scale, 1).
6-17. paths : ``register`` / ``register_multires`` / ``warp_labels`` of the
              size^3 synthetic pair through each path of the port, every
              launch count set to 0 just before a path and read just after;
              each kernel of the path must have launched and no plain
              version may have run:
              solve          fd8-cubic, fp32, fused matvec (K1, K2, K3)
              solve_planfree fd8-cubic, use_plan=False, bf16 weights (K1,
                             bf16 K2 in the characteristics, bf16 K4), then
                             Dice of warp_labels (K4 linear, fp32)
              solve_mixed    fd8-cubic, plans, bf16 weights, fused matvec
                             (K1, bf16 K2, bf16 K3)
              multires       register_multires, 3 levels, fused matvec
              variants       plan-free fd8-cubic fp32, fd8-lagrange fp32 and
                             bf16, fd8-linear bf16, two Newton steps each (the
                             other K4 variants)
              solve_slab     register_sharded on a one-rank NCCL group the
                             script opens (tcp://127.0.0.1) and closes:
                             fd8-cubic, fp32, fused matvec, halo 6 (K5, K1,
                             K2, K3 on halo-extended slabs); the solve's
                             Newton and PCG counts, v within 1e-4 * max|v|
              solve_ncc      ``repro_torch.api.Solver`` (mode single, NCC,
                             fused) on the contrast-inverted pair
                             (``make_multimodal_pair``) with its labels: K1,
                             K2, K3 and K4 linear (the facade's Dice); det F
                             min > 0
              solve_ngf      ``register(measure="ngf")``, fused, on the same
                             pair, capped at NGF_MAX_NEWTON steps: K1, K2,
                             K3, FD8 >= 6 launches a matvec (det F reported)
              batch          ``register_batch`` of ``make_batch`` (B = 2,
                             pair 0 = the solve path's pair), fused, donating
                             step: pair 0 takes the solve path's Newton and
                             PCG counts, v within 1e-6 * max|v|
              ensemble_slab  the same batch through ``register_sharded`` on
                             a 1 x 1 ensemble x slab layout of the one-rank
                             NCCL group (K5, K1, K2, K3): the batch's counts,
                             v within 1e-4 * max|v|
              cli            ``repro_torch.launch.register.main(["--config",
                             "claire_256", "--device", "cuda"])`` in process
              baseline_gd    ``core.baseline_gd.solve``, fd8-cubic, five
                             iterations, its gradient norms beside GN's
              serve          ``repro_torch.serve.Server`` (max_batch 2, fused
                             matvec, a checkpointed cache in a temporary
                             directory, the other fields at their defaults)
                             on the batch's pairs in three rounds, each
                             waited on: A and B cold (the batch's counts, v
                             within 1e-6 * max|v|), A again (warm, strictly
                             fewer Newton steps) and B drifted (m1 moved by
                             0.9 v_true, warm), pair 0 alone with no subject
                             (a padded wave, A's cold counts); then the
                             summary, A's checkpoint step and a fresh cache's
                             bit-equal reload of A's velocity
              serve_slab     the cold round through the server's mesh mode
                             on the 1 x 1 layout of a one-rank NCCL group
                             (K5 too): the cold round's counts, v within
                             1e-4 * max|v|
              serve_cli      ``repro_torch.launch.serve_registration.main(
                             ["--smoke", "--device", "cuda"])`` in process
                             (12^3 and 16^3, 6 requests; the launcher keeps
                             the plan-path matvec, so K1 and K2)
              serve_lm:qwen1.5-0.5b  ``repro_torch.launch.serve_lm.serve`` at
                             full width (24 layers, MHA, random seeded
                             weights, bf16): 8 requests x 2048-token prompt
                             + 64 generated; K6 once per layer
              serve_sharded:qwen1.5-0.5b  right after it, the same prompts
                             through ``repro_torch.train.steps``'
                             ``make_prefill_step`` and 16 greedy steps of
                             ``make_decode_step`` on the one-rank NCCL
                             (data, model) mesh, from the rank's param and
                             cache blocks (the model's per-layer weights made
                             views of the stacked leaves first): the prefill
                             logits bit-equal to serve_lm's, the ids equal to
                             its first 17, K6 once per layer (the model has
                             one code path for every mesh: this checks the
                             steps' blocks, rows and gathers on NCCL)
              serve_lm:smollm-135m   30 layers, GQA (K/V repeated), 8 x 2000
                             (a ragged tail) + 48
              serve_lm:deepseek-moe-16b  28 layers (a dense first layer, 27
                             MoE: 64 experts top-6, 2 shared), 8 x 2048 + 32,
                             K6 28 times a prefill, and the capacity-drop
                             share of one more prefill
              serve_sharded:deepseek-moe-16b  as serve_sharded:qwen1.5-0.5b
                             (K6 28 times)
              serve_lm:mamba2-780m   48 SSD layers, 8 x 2048 + 64, no K6
              serve_lm:jamba-v0.1-52b  one 8-layer period of the 32 (printed
                             under ``reduced``), GQA 32/8, MoE 16 top-2,
                             8 x 2048 + 32, K6 once
              serve_lm:whisper-large-v3  32 + 32 layers, 8 x 1500 frames
                             (187 decoder tokens) + 32, K6 64 times
              serve_lm:internvl2-1b  24 layers, GQA 14/2, 8 x (256 patches +
                             1792 tokens) + 64, K6 24 times
                             The five draw their weights on the card; each
                             model is freed before the next.
              train_parity   one fp32 train step (``repro_torch.train``) of each
                             family's smoke config (TRAIN_PARITY) on the card and
                             on the CPU from the same weights and batch: loss,
                             grad norm and every gradient leaf; the card's new
                             params and AdamW state against the CPU's
                             ``adamw_update`` of the card's gradients; no kernel
                             launched (K6 has no backward)
              train:smollm-135m  ``repro_torch.launch.train``'s Trainer at the
                             published width (TRAIN_ARGV): 6 steps of 8 x 2048
                             tokens, each step's loss, grad norm, seconds and
                             tokens/s, the peak memory above the script's own
                             tensors, the step-6 loss below the step-1 loss;
                             then a new trainer restored from the step-3
                             checkpoint (bit-equal to the state saved) runs
                             steps 4-6. Launch counts cover the whole run,
                             backward recomputation included (none: the
                             training path launches no kernel). Each step's
                             model-FLOPs share ``mfu``: 6 N D / (step s x
                             989 TFLOP/s, ``repro_torch.roofline``).
              train_sharded:smollm-135m  the same Trainer with ``--mesh-shape
                             1,1`` on a one-rank NCCL (data, model) mesh that
                             the script opens and closes (the sharded step:
                             ZeRO-1 blocks, gathers, data-axis means), steps
                             1-3 of the same schedule and batches: loss and
                             grad norm within TRAIN_LOSS_REL / TRAIN_GRAD_REL
                             of train:smollm-135m's, params within
                             TRAIN_GRAD_REL * max|leaf| of its step-3 state
                             (bit-equality reported); then a mesh Trainer
                             restores that run's step-3 checkpoint, bit-equal.
              compression    ``compressed_psum_pod`` on that NCCL group over
                             bf16 gradients of smollm's largest shapes:
                             bit-equal to its plain version (one rank's
                             payload dequantised; a self-consistency check,
                             since one rank puts no byte on the wire), within
                             2e-2 * max|g| of the exact mean. The
                             collective's parity over several ranks is held
                             by tests/test_torch_compression.py (4 gloo ranks
                             against JAX) and test_torch_gpu.py (one NCCL
                             rank a card).
              ensemble_step:claire_256  ``claire_dist.ensemble_newton_step``
                             (the dry-run's registration cell: fd8-cubic
                             plans, GNConfig(max_pcg=6, ls_max=1)) on two
                             seeded size^3 pairs from v = 0: K1 and K2; each
                             pair's stats and v_new bit-equal to
                             ``gauss_newton.make_step`` on that pair alone;
                             its wall time and peak
              dryrun         ``repro_torch.launch.dryrun``'s predictions (fake
                             tensors, a one-rank fake world, in three spawned
                             processes) beside measured runs on the card: one
                             step of
                             train:smollm-135m (8 x 2048; peak above its
                             arguments, FlopCounterMode's FLOPs, the phase's
                             steady step time and its peak), the
                             qwen1.5-0.5b prefill of serve_lm (8 x 2048; K6's
                             predicted launches against the path's counted
                             ones) and the ensemble step (its wall time, also
                             at the PCG and line-search counts it took);
                             then the records of JAX's test cell
                             (smollm-135m decode_32k multi), smollm-135m
                             train_4k single and both claire_256_ensemble
                             modes, each a ``python -m
                             repro_torch.launch.dryrun`` subprocess
              examples       each script of examples_torch/ as a subprocess on
                             the card at EXAMPLES_ARGV (run beside the dry-run
                             records): exit code, seconds, its last line
18. times   : each kernel at its main-path shape (CUDA events after warm-up)
              beside its bound, its plain version and the library call that
              computes the same function, where there is one (K6: SDPA); K4
              also at uniform queries, K6 also with a query offset at
              K6_OFFSET (bound over the unmasked pairs, SDPA with the same
              boolean mask), the plan build (cubic B-spline, fp32 and bf16
              weights, the other bases beside) against its byte bound, and
              ptxas' registers and spills of each K2 / K4 variant.
19. profile : the fp32, the plan-free and the slab solve once more under
              torch.profiler: device time by kernel group (NCCL included)
              and the device's idle share of the unprofiled wall time; the
              server's cold round (idle share of its latency in phase
              serve); then
              the qwen1.5-0.5b prefill (K6, matmuls, elementwise) and its
              decode loop (idle share); deepseek-moe-16b's prefill and one
              decode step (measured right after its path), split into K6,
              the expert GEMMs, the dispatch/combine einsums, routing and
              elementwise ops by ``moe:<stage>`` profiler ranges; one more
              train:smollm-135m step, its forward and its AdamW update in
              ``train:forward`` / ``train:adamw`` ranges.

Then a ``script`` line (the script's wall time, and the shares of the five
non-dense LM paths, of the training phases and of ensemble_step, dryrun
and examples), the ``nvidia-smi`` name/power-limit line, a JSON line ``{"kernels":
[...]}`` and, last, ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import typing

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.roofline.analysis import HW, kernel_roofline  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, ``repro_torch.roofline.analysis.HW``):
#: fp32 non-tensor flop/s, bf16 dense tensor-core flop/s.
PEAK_FP32_FLOPS = HW["peak_fp32_flops"]
PEAK_BF16_FLOPS = HW["peak_flops"]

K1_RTOL, K1_ATOL = 1e-5, 1e-4
PLAN_REL = 1e-5            # K2/K3/K4: max|kernel - plain| <= 1e-5 * max(|plain|, 1)
MATVEC_REL = 1e-5          # fused vs plan matvec, as tests/test_fused_matvec.py
REF_V_REL = 1e-4           # 16^3 solve, card vs CPU: max|dv| <= 1e-4 * max|v|
SLAB_V_REL = 1e-4          # slab vs single-device solve: max|dv| <= 1e-4 * max|v|
BATCH_V_REL = 1e-6         # batch pair 0 vs the solve path: max|dv| <= 1e-6 * max|v|
SERVE_V_REL = 1e-6         # the server's cold wave vs the batch: max|dv| <= 1e-6 * max|v|
SERVE_GNORM_REL = 1e-5     # a warm revisit's gnorm0 vs the cold visit's, relative
K5_REL = 1e-5              # K5: max|kernel - plain| <= 1e-5 * max(|plain|, 1)
#: K6 vs plain, (rtol, atol) per dtype. fp32: tests/test_flashattn.py's.
#: bf16: kernel and plain version both accumulate in fp32 and round once, so
#: they differ by at most one ulp of the bf16 output, which is at most
#: 2^-7 |x| (rtol 8e-3), plus the fp32 order noise of outputs near 0 (atol);
#: and only where the fp32 values straddle a rounding boundary, so at most
#: K6_BF16_DIFFER of the elements may differ at all.
K6_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (8e-3, 1e-4)}
K6_BF16_DIFFER = 0.05
LM_FP32_REL = 1e-4         # fp32 logits, card vs CPU: <= 1e-4 * max|logits|
LM_BF16_ATOL = 0.02        # bf16 logits, card vs CPU (tests/test_torch_lm.py)
TIMING_REPS, PLAIN_REPS = 20, 2

_PENCIL = ("src/repro_torch/csrc/pencil.cu", "src/repro/kernels/pencil.py:135")
_K5 = ("src/repro_torch/csrc/pencil.cu", "src/repro/kernels/pencil.py:81")
_K2 = ("src/repro_torch/csrc/interp3d.cu", "src/repro/kernels/interp3d/interp3d.py:247")
_K3 = ("src/repro_torch/csrc/interp3d.cu", "src/repro/kernels/interp3d/interp3d.py:339")
_K4 = ("src/repro_torch/csrc/interp3d.cu", "src/repro/kernels/interp3d/interp3d.py:150")
_K6 = ("src/repro_torch/csrc/flashattn.cu", "src/repro/kernels/flashattn/flashattn.py:72")
_PLAN = ("src/repro_torch/csrc/plan.cu",
         "none (the JAX package's build_plan, src/repro/core/interp.py:265, is jnp)")
_CONTRACT = ("src/repro_torch/csrc/contract.cu",
             "none (the JAX package's einsums in src/repro/core/hessian.py and transport.py, "
             "left to XLA)")
K4_BASES = ("linear", "cubic_bspline", "cubic_lagrange")

#: kernel (launch-count key) -> (source, Pallas kernel it replaces).
KERNELS = {
    "stencil_axis:fd8": _PENCIL,
    "stencil_axis:prefilter": _PENCIL,
    "apply_plan": _K2,
    "apply_plan:bf16": _K2,
    "apply_plan_fused:inc_state": _K3,
    "apply_plan_fused:inc_adjoint": _K3,
    "apply_plan_fused:inc_state:bf16": _K3,
    "apply_plan_fused:inc_adjoint:bf16": _K3,
    **{f"interp3d:{b}{w}": _K4 for b in K4_BASES for w in ("", ":bf16")},
    "stencil_valid:fd8": _K5,
    "flash_attention": _K6,
    "build_plan:cubic_bspline": _PLAN,
    "build_plan:cubic_bspline:bf16": _PLAN,
    "traj_source": _CONTRACT,
    "traj_body_force": _CONTRACT,
}

_K1_KEYS = ["stencil_axis:fd8", "stencil_axis:prefilter"]
#: the contractions: each Hessian matvec launches both, each gradient the body force
_CONTRACTIONS = ["traj_source", "traj_body_force"]
_FUSED = ["apply_plan_fused:inc_state", "apply_plan_fused:inc_adjoint"]
#: path -> (entry-point keywords, kernels that must launch on it).
PATHS = {
    "solve": (dict(variant="fd8-cubic", use_fused_matvec=True),
              _K1_KEYS + ["build_plan:cubic_bspline", "apply_plan"] + _FUSED + _CONTRACTIONS),
    "solve_planfree": (dict(variant="fd8-cubic", use_plan=False, mixed_precision=True),
                       _K1_KEYS + ["build_plan:cubic_bspline:bf16", "apply_plan:bf16",
                                   "interp3d:cubic_bspline:bf16"] + _CONTRACTIONS),
    "solve_mixed": (dict(variant="fd8-cubic", mixed_precision=True, use_fused_matvec=True),
                    _K1_KEYS + ["build_plan:cubic_bspline:bf16", "apply_plan:bf16"]
                    + [k + ":bf16" for k in _FUSED] + _CONTRACTIONS),
}
#: the slab path (one-rank NCCL group) and the kernels it must launch.
SLAB_KW = dict(variant="fd8-cubic", use_fused_matvec=True, halo=6)
SLAB_REQUIRED = (["stencil_valid:fd8"] + _K1_KEYS + _CONTRACTIONS
                 + ["build_plan:cubic_bspline", "apply_plan"]
                 + _FUSED)
#: the paths of the facade, the measures, the batch and the ensemble x slab
#: layout: kernels that must launch (NCC adds K4 linear for the facade's Dice)
PLAN_FUSED = _K1_KEYS + ["apply_plan"] + _FUSED + _CONTRACTIONS
NCC_REQUIRED = PLAN_FUSED + ["interp3d:linear"]
#: NGF's Newton caps. At 256^3 its fourth step already meets non-positive
#: curvature, PCG runs to its 500-iteration cap (~12 s a step on the H100)
#: and the gradient norm stalls (PERF.md §6); at 16^3 that happens from
#: the sixth step on.
NGF_MAX_NEWTON = 3
REF_NGF_MAX_NEWTON = 4
#: NGF, card vs CPU at 16^3: equal counts and v within 1e-2 * max|v|. NGF's
#: GN density divides by (|grad m|^2 + eps^2)^2, which amplifies fp32
#: ordering noise: the JAX package and the port, both on the CPU, differ by
#: 2.8e-3 * max|v| after four steps at equal counts.
REF_NGF_V_REL = 1e-2
#: the plan-free variants that reach the other K4 variants (two Newton steps).
VARIANT_PATHS = {
    "planfree:fd8-cubic": (dict(variant="fd8-cubic", use_plan=False),
                           ["interp3d:cubic_bspline"]),
    "planfree:fd8-lagrange": (dict(variant="fd8-lagrange", use_plan=False),
                              ["interp3d:cubic_lagrange"]),
    "planfree:fd8-lagrange:bf16": (dict(variant="fd8-lagrange", use_plan=False,
                                        mixed_precision=True),
                                   ["interp3d:cubic_lagrange:bf16"]),
    "planfree:fd8-linear:bf16": (dict(variant="fd8-linear", use_plan=False,
                                      mixed_precision=True),
                                 ["interp3d:linear:bf16"]),
}
#: K6 cases: label -> (BH, S, hd, dtype, causal flags); (a) is the
#: qwen1.5-0.5b serving prefill, 8 requests x 16 heads x 2048 tokens. Phase
#: kernels adds the prefill shape of every path of LM_PATHS.
K6_CASES = {
    "a": (128, 2048, 64, "bfloat16", (False, True)),
    "b": (16, 1000, 64, "float32", (False, True)),
    "c": (28, 1024, 128, "bfloat16", (True,)),
    "d": (16, 16384, 64, "bfloat16", (True,)),
}
#: K6 with a query offset: smollm-135m's sequence-parallel prefill on a
#: model axis of 4 (8 requests x 9 heads, 2048 keys, a rank's 512 query rows
#: at each rank's offset), hd 64, causal: (BH, S_kv, S_q, hd, offsets).
K6_OFFSET = (72, 2048, 512, 64, (0, 512, 1024, 1536))
#: bf16 K6 at one query row, part tiles and one whole tile: (BH, S) per hd.
K6_EDGE = [(3, 1), (3, 37), (3, 64), (3, 2000), (2, 4097)]
#: K1 at the shapes its tiling makes awkward, K=3 stacks: n < R (the wrap
#: goes round more than once), 72 and 282 rows (the slab prefilter's), x3 not
#: a multiple of 4 (the scalar shared-memory path).
K1_EDGE_SHAPES = [(3, 5, 5, 5), (3, 72, 72, 72), (3, 282, 256, 256), (2, 6, 9, 75)]
#: K5 on each axis of a K=3 stack of 72 x 72 x 72 with that axis n_loc + 2R
#: rows long: n_loc < R, a part chunk (61, 130), the scalar rows path
#: (axis 2 at 61, 130 and 2).
K5_EDGE_NLOC = (2, 61, 130)
#: past this many score elements the K6 check runs the plain version per head
PLAIN_SCORES_MAX = 2 ** 31
class LMPath(typing.NamedTuple):
    """One LM serving path: ``requests`` x ``prompt`` (tokens; frames for
    encdec; patches + text tokens for vlm) + ``gen`` generated, K6 launches
    per prefill, config fields cut to fit one card (name -> value), and the
    device of the generator that draws the weights."""

    arch: str
    requests: int
    prompt: int
    gen: int
    k6: int
    reduced: dict = {}
    init_on: str = "cpu"


#: LM serving paths at published widths. The five non-dense families draw
#: their weights with a generator on the card (a CPU draw of deepseek's 16 B
#: normals and its pageable copy would take minutes). Jamba keeps one of its
#: four 8-layer periods: 32 layers, 51.5 B params in 103 GB of bf16, exceed
#: one 80 GB card.
LM_PATHS = {
    "serve_lm:qwen1.5-0.5b": LMPath("qwen1.5-0.5b", 8, 2048, 64, 24),
    "serve_lm:smollm-135m": LMPath("smollm-135m", 8, 2000, 48, 30),
    "serve_lm:deepseek-moe-16b": LMPath("deepseek-moe-16b", 8, 2048, 32, 28, init_on="cuda"),
    "serve_lm:mamba2-780m": LMPath("mamba2-780m", 8, 2048, 64, 0, init_on="cuda"),
    "serve_lm:jamba-v0.1-52b": LMPath("jamba-v0.1-52b", 8, 2048, 32, 1, {"n_layers": 8},
                                      init_on="cuda"),
    "serve_lm:whisper-large-v3": LMPath("whisper-large-v3", 8, 1500, 32, 64, init_on="cuda"),
    "serve_lm:internvl2-1b": LMPath("internvl2-1b", 8, 2048, 64, 24, init_on="cuda"),
}
#: serve_sharded: the serving paths driven again, while their model is on the
#: card, through the sharded prefill and decode steps (``train.steps``) on
#: the one-rank NCCL (data, model) mesh: serve_lm label -> phase label; the
#: decode steps held to the serve_lm phase's ids.
SERVE_SHARDED = {"serve_lm:qwen1.5-0.5b": "serve_sharded:qwen1.5-0.5b",
                 "serve_lm:deepseek-moe-16b": "serve_sharded:deepseek-moe-16b"}
SERVE_SHARDED_DECODE = 16
#: reference_lm: arch -> (requests, prompt) of its smoke config's batch; the
#: MoE families need B * S a multiple of the 128-token group.
REF_LM = {"qwen1.5-0.5b": (3, 100), "smollm-135m": (3, 100), "deepseek-moe-16b": (2, 64),
          "mamba2-780m": (2, 64), "jamba-v0.1-52b": (2, 64), "whisper-large-v3": (2, 64),
          "internvl2-1b": (2, 64)}
#: train:smollm-135m: ``repro_torch.launch.train``'s arguments at the
#: published width (30 layers, d 576, GQA 9/3, vocab 49 152, bf16 params with
#: fp32 master, m and v): 8 x 2048 tokens a step from ``SyntheticTokens``, 6
#: steps with the launcher's AdamWConfig(lr=3e-4, total_steps=6,
#: warmup_steps=1), a checkpoint every 3 steps; then a new trainer restored
#: from the step-3 checkpoint runs steps 4-6 on the same stream.
TRAIN_ARGV = ["--arch", "smollm-135m", "--steps", "6", "--batch", "8", "--seq", "2048",
              "--ckpt-every", "3", "--device", "cuda"]
#: train_parity: family -> arch whose fp32 smoke config takes one train step
#: on the card and on the CPU from the same weights and batch (2 x 64 tokens:
#: B * S a multiple of the MoE's 128-token group).
TRAIN_PARITY = {"dense": "smollm-135m", "moe": "deepseek-moe-16b", "ssm": "mamba2-780m",
                "hybrid": "jamba-v0.1-52b", "encdec": "whisper-large-v3",
                "vlm": "internvl2-1b"}
#: train_sharded:smollm-135m: steps of TRAIN_ARGV's schedule on the one-rank mesh
TRAIN_SHARDED_STEPS = 3
TRAIN_LOSS_REL = 1e-5      # fp32 loss, card vs CPU (tests/test_torch_train_loss.py's rtol)
TRAIN_GRAD_REL = 1e-4      # each gradient leaf and the grad norm, vs max|CPU leaf| / the norm
#: the card's new params and AdamW state against the CPU's ``adamw_update``
#: of the card's gradients: 1e-6 * |x| + 1e-6 * max|leaf| (tests/test_torch_adamw.py).
#: Not against the CPU's own step: Adam's first move is sign(g) * lr, and a
#: gradient element within the gradient tolerance of 0 may step either way.
TRAIN_UPDATE_REL = 1e-6
#: ensemble_step:claire_256: the dry-run's registration cell (one Newton
#: step, 6 PCG matvecs, one line-search trial) on two seeded pairs, the
#: kernels it must launch (the dry-run's transport: plans, no fused matvec)
ENSEMBLE_PAIRS = 2
ENSEMBLE_REQUIRED = _K1_KEYS + ["apply_plan"] + _CONTRACTIONS
#: dryrun: the records of JAX's test cell, one train cell and both
#: registration modes, each a ``python -m repro_torch.launch.dryrun`` run
DRYRUN_RECORDS = {
    "smollm-135m decode_32k multi": ["--arch", "smollm-135m", "--shape", "decode_32k",
                                     "--mesh", "multi"],
    "smollm-135m train_4k single": ["--arch", "smollm-135m", "--shape", "train_4k",
                                    "--mesh", "single"],
    "claire_256_ensemble ensemble single": ["--claire", "claire_256_ensemble",
                                            "--claire-mode", "ensemble", "--mesh", "single"],
    "claire_256_ensemble slab single": ["--claire", "claire_256_ensemble",
                                        "--claire-mode", "slab", "--mesh", "single"],
}
#: examples: each script of examples_torch/ on the card at small arguments
EXAMPLES_ARGV = {
    "quickstart": ["--grid", "16"],
    "registration_3d": ["--grid", "16", "--max-newton", "3"],
    "multires_registration": ["--grid", "16", "--max-newton", "3"],
    "multimodal_registration": ["--grid", "12", "--max-newton", "3"],
    "ensemble_registration": ["--grid", "16", "--batch", "2", "--newton-steps", "2"],
    "serve_registration": ["--grid", "16", "--subjects", "2", "--max-newton", "4"],
    "serve_lm": ["--requests", "4", "--prompt", "64", "--gen", "8"],
    "train_lm": ["--steps", "5", "--batch", "4", "--seq", "64"],
}
SIDE_TIMEOUT_S = 300
#: dryrun: the predicted products' FLOPs against FlopCounterMode's on the card
DRYRUN_FLOPS_REL = 0.01


def emit(phase: str, **fields) -> None:
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def k6_close(got, ref, dt: str):
    """K6's check against its plain version at ``K6_TOL``: (ok, max |got -
    ref|, share of the elements that differ)."""
    rtol, atol = K6_TOL[dt]
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    differ = float((d > 0).float().mean())
    ok = bool((d <= atol + rtol * ref.abs()).all())
    if dt == "bfloat16":
        ok = ok and differ <= K6_BF16_DIFFER
    return ok, float(d.max()), differ


def k6_faulty(q, k, v, causal: bool, fault: str):
    """K6's plain version with one fault, to show that ``k6_close`` sees it:
    ``p_bf16`` rounds P to bf16 before P.V; ``drop_tile`` leaves out the last
    64-row key tile."""
    import torch

    s_len, hd = q.shape[-2:]
    s = (q.float() * (1.0 / math.sqrt(hd))) @ k.float().transpose(-1, -2)
    pos = torch.arange(s_len, device=q.device)
    if causal:
        s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    if fault == "drop_tile":
        s[..., (s_len - 1) // 64 * 64:] = -1e30
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if fault == "p_bf16":
        p = p.bfloat16().float()
    return ((p @ v.float()) / torch.clamp(l, min=1e-30)).to(q.dtype)


def timed(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_kernels(lines, marks):
    """{kernel: registers, stack frame and spills} from ``nvcc -Xptxas -v``
    lines, for the kernels whose mangled name holds one of ``marks``; names
    demangled by ``c++filt`` where it exists."""
    import re

    found, name = {}, None
    for ln in lines:
        hit = re.search(r"Compiling entry function '(\w+)'", ln)
        if hit:
            name = hit.group(1) if any(m in hit.group(1) for m in marks) else None
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", ln)
        if hit:
            found.setdefault(name, {}).update(
                stack=int(hit.group(1)), spill_stores=int(hit.group(2)),
                spill_loads=int(hit.group(3)))
        hit = re.search(r"Used (\d+) registers", ln)
        if hit:
            found.setdefault(name, {})["registers"] = int(hit.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(found), capture_output=True,
                               text=True, timeout=30).stdout.splitlines()
    except OSError:
        names = []
    if len(names) != len(found):
        names = list(found)
    short = [re.search(r"\w+<[^>]*>", nm) for nm in names]
    return {(sh.group(0) if sh else nm): v
            for nm, sh, v in zip(names, short, found.values())}


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(ms, "bytes" or "operations"): ``kernel_roofline``'s bound of moving
    ``nbytes`` through HBM and doing ``flops`` at ``peak_flops``."""
    r = kernel_roofline(flops, nbytes, hw=dict(HW, peak_flops=peak_flops))
    return r.roofline_s * 1e3, "bytes" if r.bound == "memory" else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def plan_bytes(plan) -> int:
    return nbytes(*plan.idx, *plan.weights)


def plan_differ(got, ref) -> dict:
    """The kernel's plan against the plain build's ``(idx, weights)``, bit
    for bit: elements whose bits differ (weights viewed as integers of their
    width, so -0 against +0 shows) and the largest absolute gap."""
    import torch

    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

    def bits(t):
        return t.view(view.get(t.dtype, t.dtype))

    pairs = list(zip(got.idx, ref[0])) + list(zip(got.weights, ref[1]))
    differ = sum(int((bits(g) != bits(r)).sum()) for g, r in pairs)
    gap = max(float((g.double() - r.double()).abs().max()) for g, r in pairs)
    return dict(differ=differ, max_abs_err=gap,
                ok=differ == 0 and all(g.dtype == r.dtype and g.shape == r.shape
                                       for g, r in pairs))


def circular_conv(taps, symmetric: bool, scale: float, axis: int, device):
    """A ``torch.nn.Conv3d`` with circular padding computing the same periodic
    stencil (the library yardstick of K1; the port never calls it)."""
    import torch

    r = len(taps) - 1 if symmetric else len(taps)
    w = torch.zeros(2 * r + 1, dtype=torch.float64)
    if symmetric:
        w[r] = taps[0]
        for k in range(1, r + 1):
            w[r + k] = w[r - k] = taps[k]
    else:
        for k in range(1, r + 1):
            w[r + k] = taps[k - 1]
            w[r - k] = -taps[k - 1]
    ksize = [1, 1, 1]
    ksize[axis] = 2 * r + 1
    pad = [0, 0, 0]
    pad[axis] = r
    conv = torch.nn.Conv3d(1, 1, tuple(ksize), padding=tuple(pad),
                           padding_mode="circular", bias=False)
    with torch.no_grad():
        conv.weight.copy_((w * scale).reshape(1, 1, *ksize))
    return conv.to(device).requires_grad_(False)


def attention_flops(bh: int, s: int, hd: int, causal: bool) -> float:
    """Flops this call's data needs: 4 hd per (query, key) pair that is not
    masked (2 hd for q k^T, 2 hd for p v)."""
    pairs = s * (s + 1) / 2 if causal else s * s
    return 4.0 * hd * bh * pairs


def lm_config(path: LMPath):
    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS[path.arch], **path.reduced)


def k6_per_prefill(cfg) -> int:
    """K6 launches of one prefill: one per self-attention layer, the
    encoder's included."""
    from repro_torch.models import transformer as T

    attn = sum(n_rep * sum(mixer == "attn" for mixer, _ in sigs)
               for n_rep, sigs in T.segments(cfg))
    return attn + (cfg.n_enc_layers if cfg.is_encdec else 0)


def lm_k6_shapes(cfg, b: int, prompt: int):
    """The K6 calls of one prefill: [(suffix, BH, S, hd, causal)] (the
    encoder's non-causal over the frames, the decoder's over dec_len)."""
    if not cfg.n_heads:
        return []
    bh = b * cfg.n_heads
    if cfg.is_encdec:
        dec = max(prompt // cfg.dec_ratio, 16)
        return [(":enc", bh, prompt, cfg.head_dim, False), (":dec", bh, dec, cfg.head_dim, True)]
    return [("", bh, prompt, cfg.head_dim, True)]


@contextlib.contextmanager
def routing_spy():
    """Collect every MoE routing (``models.moe.route``'s result) made inside
    the block."""
    from repro_torch.models import moe as MOE

    calls, route = [], MOE.route

    def spy(*args, **kwargs):
        r = route(*args, **kwargs)
        calls.append(r)
        return r

    MOE.route = spy
    try:
        yield calls
    finally:
        MOE.route = route


@contextlib.contextmanager
def grads_spy():
    """Collect the gradients each train step hands to ``adamw_update``
    inside the block (``repro_torch.train.steps``)."""
    from repro_torch.train import steps as TS

    seen, update = [], TS.adamw.adamw_update

    def spy(cfg, grads, opt, params, **kw):
        seen.append(grads)
        return update(cfg, grads, opt, params, **kw)

    TS.adamw.adamw_update = spy
    try:
        yield seen
    finally:
        TS.adamw.adamw_update = update


@contextlib.contextmanager
def train_ranges(model):
    """Profiler ranges ``train:forward`` (``Model.loss``) and
    ``train:adamw`` (the update) inside the block; the rest of a step's
    device time is the backward, recomputation included."""
    import torch
    from repro_torch.train import steps as TS

    update, loss = TS.adamw.adamw_update, model.loss

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    TS.adamw.adamw_update = ranged("train:adamw", update)
    model.loss = ranged("train:forward", loss)
    try:
        yield
    finally:
        TS.adamw.adamw_update = update
        del model.loss


def tree_bits_equal(a, b) -> bool:
    """Two trees (``optim.adamw.leaves`` order) with bit-equal leaves."""
    import torch
    from repro_torch.optim import adamw as OPT

    la, lb = OPT.leaves(a), OPT.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def update_dev(got, ref) -> float:
    """max over leaves of max(|got - ref| / (|ref| + max|ref leaf|)): <= r
    means within r * |x| + r * max|leaf| (0 where both leaves are 0)."""
    from repro_torch.optim import adamw as OPT

    worst = 0.0
    for g, r in zip(OPT.leaves(got), OPT.leaves(ref)):
        g, r = g.detach().cpu().float(), r.float()
        scale = r.abs() + float(r.abs().max())
        d = (g - r).abs()
        worst = max(worst, float((d / scale.clamp(min=1e-30)).max()) if float(d.max()) else 0.0)
    return worst


def k6_offset_cost(bh: int, s_kv: int, s_q: int, hd: int, offset: int, itemsize: int):
    """(flops, bytes) K6 with a query offset needs, causal: 4 hd per unmasked
    (query, key) pair; q and out once, and K/V up to the last query's key."""
    pairs = bh * (s_q * offset + s_q * (s_q + 1) / 2)
    keys = offset + s_q
    return 4.0 * hd * pairs, itemsize * bh * hd * (2 * s_q + 2 * keys)


def stack_in_place(model):
    """The model's params as a tree in the JAX layout (each segment's leaves
    stacked over its repeats) whose per-layer parameters become views of the
    stacked leaves, one leaf at a time: no second copy of the weights."""
    import torch

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([t[k] for t in layers]) for k in layers[0]}
        out = torch.stack([t.detach() for t in layers])
        for r, t in enumerate(layers):
            t.data = out[r]
        return out

    p = model.params()
    tree = {k: v for k, v in p.items() if k not in ("decoder", "encoder")}
    for k in ("decoder", "encoder"):
        if k in p:
            tree[k] = {seg: {sub: stack(layers) for sub, layers in subs.items()}
                       for seg, subs in p[k].items()}
    return tree


def serve_sharded(model, batch, res, gen: int, k6: int, drive, label: str) -> dict:
    """Phase serve_sharded:<arch>, inside the script's one-rank NCCL group:
    the prompt batch of the serve_lm phase through ``train.steps``'
    ``make_prefill_step`` and SERVE_SHARDED_DECODE greedy steps of
    ``make_decode_step`` on the (data, model) = (1, 1) mesh, from the
    rank's ``param_specs`` and ``cache_specs`` blocks; the prefill's logits
    and the ids bit-equal to the serve_lm phase's (``res``), K6 launched
    once a self-attention layer. The model runs the same code as in
    serve_lm (one form for every mesh, a one-rank model group): what this
    holds are the steps' wrappers on an NCCL mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as ML
    from repro_torch.launch import serve_lm
    from repro_torch.train import steps as TS

    t0 = time.perf_counter()
    tree = stack_in_place(model)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    mesh = ML.make_mesh((1, 1), ("data", "model"))
    params = TS.shard_params(tree, mesh)
    b, p = batch["tokens"].shape[0], serve_lm.prompt_len(batch)
    n = SERVE_SHARDED_DECODE
    prefill = TS.make_prefill_step(model, mesh)
    decode = TS.make_decode_step(model, mesh, b, p + gen)
    walls = {}

    def run():
        t = time.perf_counter()
        logits = prefill(params, batch)
        ids = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
        torch.cuda.synchronize()
        walls["prefill_s"] = time.perf_counter() - t
        cache = TS.shard_cache(model.make_cache(b, p + gen), mesh)
        t = time.perf_counter()
        for i in range(n):
            lg, cache = decode(params, cache, ids[-1], p + i)
            ids.append(torch.argmax(lg[:, -1], dim=-1)[:, None])
        torch.cuda.synchronize()
        walls["decode_s"] = time.perf_counter() - t
        return logits, torch.cat(ids, dim=1)

    (logits, ids), fields = drive(label, ["flash_attention"], run)
    want_ids = res.ids[:, :n + 1]
    logits_equal = tree_bits_equal(logits, res.prefill_logits)
    ids_equal = torch.equal(ids, want_ids)
    launched = fields["launches"].get("flash_attention", 0)
    ok = (logits_equal and ids_equal and launched == k6 and not fields["missing"]
          and not fields["plain_runs"] and not mesh.abstract)
    fields.pop("wall_s")
    return dict(ok=ok, mesh={k: v for k, v in mesh.shape.items()}, backend=dist.get_backend(),
                requests=b, prompt_len=p, decode_steps=n,
                prefill_logits_bit_equal=logits_equal, ids_equal=ids_equal,
                k6_launches=launched, k6_expected=k6, stack_in_place_s=stack_s,
                prefill_s=walls["prefill_s"], decode_s=walls["decode_s"],
                decode_tok_s=b * n / walls["decode_s"], ids_first_request=ids[0].tolist(),
                peak_gb_less_script=(fields["max_memory_allocated"]
                                     - fields["memory_allocated_before"]) / 1e9, **fields)


def train_sharded(TL, saved3, log3, ckpt_a: pathlib.Path, tmp: pathlib.Path, drive,
                  seed: int) -> dict:
    """Phase train_sharded:smollm-135m, inside the script's one-rank NCCL
    group: the launcher's Trainer of TRAIN_ARGV with ``--mesh-shape 1,1``
    (the sharded step, ZeRO-1 layout, gathers and data-axis means over the
    mesh's groups) for TRAIN_SHARDED_STEPS steps of the same schedule and
    batches, held to steps 1-3 of train:smollm-135m (``log3``, and the state
    it saved at step 3, ``saved3``); then a mesh Trainer restores that
    run's step-3 checkpoint (``ckpt_a``), which must be bit-equal."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim import adamw as OPT

    trainer, batches = TL.make_trainer(TRAIN_ARGV + ["--mesh-shape", "1,1"])
    trainer.cfg = dataclasses.replace(trainer.cfg, total_steps=TRAIN_SHARDED_STEPS)
    state, fields = drive("train_sharded:smollm-135m", [], lambda: trainer.run(
        batches, torch.Generator().manual_seed(seed)))
    log = trainer.metrics_log
    full = trainer.full_state()
    loss_dev = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(log, log3))
    gnorm_dev = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                    for a, b in zip(log, log3))
    params_dev = max(max_err(a.float(), b.float()) / max(float(b.float().abs().max()), 1e-30)
                     for a, b in zip(OPT.leaves(full.params), OPT.leaves(saved3.params)))
    bit_equal = (tree_bits_equal([full.params, full.opt], [saved3.params, saved3.opt])
                 and [m["loss"] for m in log] == [m["loss"] for m in log3]
                 and [m["grad_norm"] for m in log] == [m["grad_norm"] for m in log3])
    ckpt_c = tmp / "c"
    shutil.copytree(ckpt_a / "step_00000003", ckpt_c / "step_00000003")
    restorer, _ = TL.make_trainer(TRAIN_ARGV + ["--mesh-shape", "1,1", "--ckpt-dir",
                                                str(ckpt_c)])
    t0 = time.perf_counter()
    restorer.init_or_restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    back = restorer.full_state()
    restored_equal = tree_bits_equal([back.params, back.opt], [saved3.params, saved3.opt])
    mesh = trainer.mesh
    ok = (mesh is not None and not mesh.abstract and len(log) == TRAIN_SHARDED_STEPS
          and [m["step"] for m in log] == list(range(1, TRAIN_SHARDED_STEPS + 1))
          and loss_dev <= TRAIN_LOSS_REL and gnorm_dev <= TRAIN_GRAD_REL
          and params_dev <= TRAIN_GRAD_REL and restored_equal and restorer.start_step == 3
          and not fields["plain_runs"] and "flash_attention" not in fields["launches"]
          and all(bool(torch.isfinite(t.float()).all()) for t in OPT.leaves(full.params)))
    wall = fields.pop("wall_s")
    return dict(
        ok=ok, arch="smollm-135m", argv=TRAIN_ARGV + ["--mesh-shape", "1,1"],
        mesh={k: v for k, v in mesh.shape.items()} if mesh else None,
        backend=dist.get_backend(), steps=[dict(step=m["step"], loss=m["loss"],
                                                grad_norm=m["grad_norm"],
                                                step_s=m["step_time_s"]) for m in log],
        reference_steps=[dict(step=m["step"], loss=m["loss"], grad_norm=m["grad_norm"])
                         for m in log3],
        bit_equal=bit_equal, loss_rel_dev=loss_dev, grad_norm_rel_dev=gnorm_dev,
        params_rel_dev=params_dev, restored_step3_equal=restored_equal,
        restore_s=restore_s, run_wall_s=wall,
        peak_gb_less_script=(fields["max_memory_allocated"]
                             - fields["memory_allocated_before"]) / 1e9,
        tol=dict(loss_rel=TRAIN_LOSS_REL, grad_rel=TRAIN_GRAD_REL), **fields)


def compression_phase(dev, seed: int) -> dict:
    """Phase compression: ``compressed_psum_pod`` on the script's one-rank
    NCCL group over gradients of smollm-135m's largest shapes (bf16 as its
    params' gradients), against its plain version (the mean of one rank's
    payload: ``dequantize_int8(*quantize_int8(g))`` cast back), which it
    must equal bit for bit (a self-consistency check: one rank sends
    nothing over the wire), and within JAX's 2e-2 * max|g| of the exact
    mean (``g`` itself); times by CUDA events."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compression as C

    gen = torch.Generator().manual_seed(seed + 7)
    grads = {"embed": torch.randn((49152, 576), generator=gen).to(dev, torch.bfloat16),
             "mlp": torch.randn((30, 576, 1536), generator=gen).to(dev, torch.bfloat16),
             "norm": (1e-3 * torch.randn((30, 576), generator=gen)).to(dev)}
    group = dist.group.WORLD

    def plain():
        return {k: C.dequantize_int8(*C.quantize_int8(g)).to(g.dtype) for k, g in grads.items()}

    got, ref = C.compressed_psum_pod(grads, group), plain()
    torch.cuda.synchronize()
    err = max(max_err(got[k].float(), ref[k].float()) for k in grads)
    rel = max(max_err(got[k].float(), grads[k].float()) / float(grads[k].float().abs().max())
              for k in grads)
    numel = sum(g.numel() for g in grads.values())
    ok = (err == 0.0 and rel <= 2e-2 and all(got[k].dtype == grads[k].dtype for k in grads)
          and all(bool(torch.isfinite(got[k].float()).all()) for k in grads))
    return dict(ok=ok, ranks=dist.get_world_size(group), backend=dist.get_backend(),
                leaves={k: [list(g.shape), str(g.dtype)] for k, g in grads.items()},
                max_abs_err_vs_plain=err, max_rel_err_vs_exact_mean=rel,
                bound_rel_vs_exact=2e-2, wire_bytes_int8=numel + 4 * len(grads),
                fp32_allreduce_bytes=4 * numel,
                ms=timed(lambda: C.compressed_psum_pod(grads, group), 10),
                plain_ms=timed(plain, 10))


@contextlib.contextmanager
def moe_ranges():
    """Wrap the MoE stages (route, dispatch, experts, combine) in profiler
    ranges ``moe:<stage>`` inside the block."""
    import torch
    from repro_torch.models import moe as MOE

    saved = {n: getattr(MOE, n) for n in ("route", "dispatch", "experts", "combine")}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"moe:{name}"):
                return fn(*args, **kwargs)
        return call

    for n, fn in saved.items():
        setattr(MOE, n, ranged(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(MOE, n, fn)


def profile_moe(model, batch, prompt: int, gen: int, res) -> list:
    """One prefill and one decode step of an MoE model under torch.profiler,
    the MoE stages in ``moe:<stage>`` ranges: device time of K6, the expert
    GEMMs (``moe:experts``), the dispatch/combine einsums and the
    elementwise group; against the path's unprofiled prefill time and its
    mean decode step."""
    import torch

    b = batch["tokens"].shape[0]
    cache = model.make_cache(b, prompt + gen)
    tok = torch.zeros((b, 1), dtype=torch.long, device=model.dev)
    out = []
    with moe_ranges():
        for label, fn, wall in (("prefill", lambda: model.prefill(batch), res.prefill_s),
                                ("decode step", lambda: model.decode_step(cache, tok, prompt),
                                 res.decode_s / gen)):
            fields = profile(f"serve_lm:{model.cfg.name} {label}", fn, wall)
            r, g = fields["device_ranges"], fields["groups_ms"]
            fields["moe_split_ms"] = {
                "K6 flash_attention": g.get("K6 flash_attention", 0.0),
                "expert GEMMs (moe:experts)": r.get("moe:experts", {}).get("ms"),
                "dispatch + combine einsums (moe:dispatch, moe:combine)":
                    sum(r.get(k, {}).get("ms", 0.0) for k in ("moe:dispatch", "moe:combine")),
                "routing (moe:route)": r.get("moe:route", {}).get("ms"),
                "elementwise / copies": g.get("elementwise / copies", 0.0)}
            out.append(fields)
    return out


def _kernel_group(key: str) -> str:
    for group, marks in (("NCCL", ("nccl",)),
                         ("K6 flash_attention", ("flash_attention",)),
                         ("K1 stencil_axis", ("stencil_axis", "stencil_strided",
                                              "stencil_rows")),
                         ("K5 stencil_valid", ("stencil_valid",)),
                         ("K3 apply_plan_fused", ("apply_plan_fused",)),
                         ("K2 apply_plan", ("apply_plan_kernel",)),
                         ("K4 interp3d", ("interp3d_kernel",)),
                         ("plan build", ("build_plan_kernel",)),
                         ("cuFFT", ("fft",)),
                         ("reductions", ("reduce", "softmax")),
                         ("cuBLAS gemv", ("gemv",)),
                         ("cuBLAS gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                         ("elementwise / copies", ("elementwise", "copy", "Memcpy",
                                                   "Memset", "fill", "cat"))):
        if any(m in key for m in marks):
            return group
    return "other"


def profile_solve(label: str, solve, unprofiled_wall_s: float) -> None:
    emit("profile", **profile(label, solve, unprofiled_wall_s))


def profile(label: str, solve, unprofiled_wall_s: float) -> dict:
    """A path's solve once more under torch.profiler: device time by kernel
    group and the device's idle share of the unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    profiled_wall = time.perf_counter() - t0
    groups, top, ranges = {}, [], {}
    for ev in prof.key_averages():
        # Kernel events only: operator events repeat their kernels' time.
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        if getattr(ev, "is_user_annotation", False) or ev.key.startswith("nccl:"):
            # Ranges on the device's timeline (NCCL's "nccl:all_gather", ...)
            # span kernels and copies counted on their own: kept apart.
            ranges[ev.key] = dict(ms=us / 1e3, count=ev.count)
            continue
        g = _kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, ev.count, ev.key[:90]))
    device_ms = sum(groups.values())
    top.sort(reverse=True)
    return dict(path=label, device_ms=device_ms, profiled_wall_s=profiled_wall,
                unprofiled_wall_s=unprofiled_wall_s,
                idle_share=1.0 - device_ms / 1e3 / unprofiled_wall_s if device_ms else None,
                groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                group_shares={g: ms / device_ms for g, ms in groups.items()}
                if device_ms else {},
                device_ranges=ranges,
                top=[dict(ms=ms, count=c, kernel=k) for ms, c, k in top[:12]])


def start_side_runs(tmp: pathlib.Path) -> dict:
    """The examples (on the card) and the dry-run records (no device), each
    a subprocess, all started at once, each waited on by a thread of its
    own: label -> (thread, result dict, out file)."""
    import threading

    def wait(proc, t0, res):
        try:
            res["stdout"], res["stderr"] = proc.communicate(timeout=SIDE_TIMEOUT_S)
            res["rc"] = proc.returncode
        except subprocess.TimeoutExpired:
            proc.kill()
            res["stdout"], res["stderr"] = proc.communicate()
            res["rc"] = None
        res["seconds"] = time.perf_counter() - t0

    cmds = {f"example:{name}": ([sys.executable, str(ROOT / "examples_torch" / f"{name}.py")]
                                + argv, None, None)
            for name, argv in EXAMPLES_ARGV.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for i, (label, argv) in enumerate(DRYRUN_RECORDS.items()):
        out = tmp / f"dryrun_{i}.jsonl"
        cmds[f"dryrun:{label}"] = ([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                                    "--out", str(out)], env, out)
    runs = {}
    for label, (cmd, cmd_env, out) in cmds.items():
        res = {}
        proc = subprocess.Popen(cmd, cwd=ROOT, env=cmd_env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        thread = threading.Thread(target=wait, args=(proc, time.perf_counter(), res))
        thread.start()
        runs[label] = (thread, res, out)
    return runs


def finish_side_runs(runs: dict) -> dict:
    """label -> dict(rc, seconds to its own exit, its last line, the
    dry-run's record); a run past SIDE_TIMEOUT_S is killed (rc None)."""
    done = {}
    for label, (thread, res, out) in runs.items():
        thread.join()
        lines = [ln for ln in res["stdout"].splitlines() if ln.strip()]
        rec = dict(rc=res["rc"], seconds=res["seconds"],
                   key_line=lines[-1] if lines else "",
                   stderr_tail=(res["stderr"].strip().splitlines()[-3:] if res["rc"] != 0
                                else []))
        if out is not None and out.exists():
            rec["record"] = json.loads(out.read_text().splitlines()[-1])
        done[label] = rec
    return done


def predict_pool(workers: int):
    """Worker processes for the dry-run's predictions (spawned: each its own
    fake world, none of this process's CUDA state)."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def rel_gap(predicted: float, measured: float) -> float:
    """(predicted - measured) / measured."""
    return (predicted - measured) / measured if measured else float("inf")


def measure_step(fn, args_bytes: int) -> dict:
    """One run of ``fn`` on the card: its peak (the allocator's peak above
    what was allocated before, plus ``args_bytes``, the step's arguments
    allocated before it) and wall time; then one more run under
    ``FlopCounterMode`` (the products PyTorch dispatches; a hand-written
    kernel is invisible to it)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = torch.cuda.max_memory_allocated() - before
    del out
    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    return dict(peak_bytes=delta + args_bytes, peak_above_args=delta, args_bytes=args_bytes,
                flops=fc.get_total_flops(), wall_s=wall)


def dryrun_comparison(preds, train, prefill, ens_wall, ens_peak, ens_args, ens_counts):
    """Phase dryrun's numbers: each prediction of ``launch.dryrun`` (one
    rank, (1, 1) mesh) beside the measured run. FLOPs compare the products
    (a kernel's FLOPs, which the dry-run adds and ``FlopCounterMode`` cannot
    see, are taken out); ok needs those within DRYRUN_FLOPS_REL and K6's
    predicted launches equal to the counted ones."""
    from repro_torch.launch import dryrun as DR

    def products(rec):
        return rec["roofline"]["hlo_flops_device"] - sum(
            k["flops"] for name, k in rec["kernels"].items() if name == "flash_attention")

    def row(rec, m, step_s):
        return dict(
            predicted_peak_gb=rec["memory"]["peak_bytes"] / 1e9,
            measured_peak_gb=m["peak_bytes"] / 1e9,
            peak_gap=rel_gap(rec["memory"]["peak_bytes"], m["peak_bytes"]),
            predicted_argument_gb=rec["memory"]["argument_bytes"] / 1e9,
            measured_argument_gb=m["args_bytes"] / 1e9,
            predicted_product_flops=products(rec), measured_flops=m["flops"],
            flops_gap=rel_gap(products(rec), m["flops"]),
            predicted_step_s=rec["roofline"]["step_s"], measured_step_s=step_s,
            step_gap=rel_gap(rec["roofline"]["step_s"], step_s),
            bound=rec["roofline"]["bound"], terms_s=[rec["roofline"][k] for k in (
                "compute_s", "memory_s", "collective_s")],
            hbm_bytes=rec["roofline"]["hlo_bytes_device"], kernels=rec["kernels"],
            run_s=rec["run_s"])

    tr, pf, en = preds["train"], preds["prefill"], preds["ensemble"]
    train_row = row(tr, train, train["steady_step_s"])
    train_row.update(phase_peak_above_script_gb=train["phase_peak_above_script"] / 1e9,
                     peak_gap_vs_phase=rel_gap(tr["memory"]["peak_bytes"],
                                               train["phase_peak_above_script"]))
    prefill_row = row(pf, prefill, prefill["prefill_s"])
    prefill_row.update(
        measured_prefill_wall_s=prefill["wall_s"],
        predicted_k6=pf["kernels"].get("flash_attention", {}).get("launches", 0),
        counted_k6=prefill["k6_launches"])
    # the registration step at the counts the run took (its PCG iterations
    # and line-search trials per pair) besides the cell's 6-matvec budget
    pieces = en["pieces"]
    measured_bytes = 0.0
    for pcg, ls in zip(*ens_counts):
        w = dict(DR.step_weights(pcg), objective=ls)
        measured_bytes += sum(w[k] * pieces[k]["mem_bytes"] for k in w)
    at_counts_s = measured_bytes / HW["hbm_bw"]
    ens_row = dict(
        pairs=en["pairs_per_rank"], predicted_peak_gb=en["memory"]["peak_bytes"] / 1e9,
        measured_peak_gb=(ens_peak + ens_args) / 1e9,
        peak_gap=rel_gap(en["memory"]["peak_bytes"], ens_peak + ens_args),
        predicted_step_s=en["roofline"]["step_s"], measured_step_s=ens_wall,
        step_gap=rel_gap(en["roofline"]["step_s"], ens_wall),
        pcg_iters=ens_counts[0], ls_evals=ens_counts[1],
        predicted_step_s_at_the_runs_counts=at_counts_s,
        step_gap_at_the_runs_counts=rel_gap(at_counts_s, ens_wall),
        bound=en["roofline"]["bound"], kernels=en["kernels"], run_s=en["run_s"])
    ok = (abs(train_row["flops_gap"]) <= DRYRUN_FLOPS_REL
          and abs(prefill_row["flops_gap"]) <= DRYRUN_FLOPS_REL
          and prefill_row["predicted_k6"] == prefill_row["counted_k6"] > 0
          and all(math.isfinite(r[k]) for r in (train_row, prefill_row, ens_row)
                  for k in ("predicted_peak_gb", "predicted_step_s")))
    return dict(ok=ok, train=train_row, prefill=prefill_row, ensemble=ens_row,
                flops_rel_tol=DRYRUN_FLOPS_REL)


@contextlib.contextmanager
def slab_group(dev):
    """A one-rank NCCL group (``repro_torch.distributed.group``) on this
    card, through a TCP store on a free local port, warmed up by one
    all-reduce and destroyed on exit."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import claire_dist as CD
    from repro_torch.distributed import group as G

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    G.init_slab_group(0, 1, f"tcp://127.0.0.1:{port}", "cuda")
    try:
        dist.all_reduce(torch.zeros(1, device=dev))
        torch.cuda.synchronize()
        yield
    finally:
        dist.destroy_process_group()


def valid_conv(taps, scale: float, device):
    """``F.conv3d`` with a (2R+1, 1, 1) kernel and no padding: the same
    valid-mode x1 stencil as K5 (the library yardstick; the port never
    calls it). Returns a function of a stack ``(B, N1, N2, N3)``."""
    import torch
    import torch.nn.functional as F

    r = len(taps)
    w = torch.zeros(2 * r + 1, dtype=torch.float64)
    for k in range(1, r + 1):
        w[r + k] = taps[k - 1]
        w[r - k] = -taps[k - 1]
    weight = (w * scale).to(torch.float32).reshape(1, 1, 2 * r + 1, 1, 1).to(device)
    return lambda x: F.conv3d(x[:, None], weight)[:, 0]


def grid_sample_linear(coef, q, pad: int):
    """The library yardstick of K4 linear (timed only; the port never calls
    it): circular padding by ``pad``, then trilinear ``grid_sample`` with
    ``align_corners=True`` at ``q`` mapped to the padded frame. Returns the
    call; its grid is computed once, here, outside the timed call."""
    import torch
    import torch.nn.functional as F

    sizes = [n + 2 * pad for n in coef.shape[-3:]]
    # grid_sample's last grid axis orders (W, H, D): axes 2, 1, 0 of q.
    grid = torch.stack([2.0 * (q[a] + pad) / (sizes[a] - 1) - 1.0 for a in (2, 1, 0)],
                       dim=-1)[None].contiguous()
    x = coef.reshape((1, -1) + tuple(coef.shape[-3:]))

    def call():
        xp = F.pad(x, (pad,) * 6, mode="circular")
        return F.grid_sample(xp, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)[0]

    return call


def k24_query_sets(foot, seed: int, dev):
    """K2 / K4 query sets: label -> (field shape, query points). The path's
    footpoints ``foot`` (also shifted by -3, and across the periodic seam by
    -9.5 and by +(n - 0.5)), uniform queries over the whole grid (every
    block's source box over budget), the footpoints of a smooth velocity on a
    5^3 and a 16 x 24 x 40 field, and ``foot`` as a flattened (1D) output."""
    import torch
    from repro_torch.core import semilag as SL
    from repro_torch.core import transport as TR
    from repro_torch.data import synthetic as S

    shape = tuple(foot.shape[1:])
    n = torch.tensor(shape, dtype=torch.float32, device=dev).reshape(3, 1, 1, 1)
    gen = torch.Generator().manual_seed(seed + 3)
    sets = {"foot": (shape, foot),
            "foot-3": (shape, (foot - 3.0).contiguous()),
            "seam-9.5": (shape, (foot - 9.5).contiguous()),
            "seam+(n-0.5)": (shape, (foot + (n - 0.5)).contiguous()),
            "uniform": (shape, (torch.rand(foot.shape, generator=gen).to(dev) * n).contiguous())}
    for small in ((5, 5, 5), (16, 24, 40)):
        v = S.random_velocity(gen, small, amplitude=0.6, device=dev)
        sets["x".join(map(str, small))] = (small, SL.trace_characteristic(v, 0.25))
    sets["flat"] = (shape, foot.reshape(3, -1))
    return sets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    t_script = time.perf_counter()

    from repro_torch import api as API
    from repro_torch import checkpoint as CK
    from repro_torch import device as D
    from repro_torch import serve as SV
    from repro_torch.configs import ARCHS, REGISTRATIONS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import baseline_gd as BGD
    from repro_torch.core import gauss_newton as GN
    from repro_torch.core import gradient as GR
    from repro_torch.core import hessian as HS
    from repro_torch.core import interp as I
    from repro_torch.core import metrics as M
    from repro_torch.core import registration as R
    from repro_torch.core import semilag as SL
    from repro_torch.core import transport as TR
    from repro_torch.data import synthetic as S
    from repro_torch.distributed import claire_dist as CD
    from repro_torch.distributed import group as G
    from repro_torch.kernels import _build, counts
    from repro_torch.kernels import contract as KC
    from repro_torch.kernels import fd8 as FD8
    from repro_torch.kernels import flashattn as FA
    from repro_torch.kernels import interp3d as K
    from repro_torch.kernels import pencil as P
    from repro_torch.kernels import plan as KP
    from repro_torch.kernels import prefilter as PF
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import register as CLI
    from repro_torch.launch import serve_lm
    from repro_torch.launch import serve_registration as SCLI
    from repro_torch.launch import train as TL
    from repro_torch.models import build_model
    from repro_torch.optim import adamw as OPT
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import model_flops
    from repro_torch.train import steps as TS

    dev = D.resolve("cuda")
    n = args.size
    shape = (n, n, n)
    bf16 = torch.bfloat16
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"

    # 1. device
    emit("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    ptxas_k3_k5 = {
        **ptxas_kernels(_build.BUILD_LOG.get("interp3d", {}).get("ptxas", []),
                        ("apply_plan_fused",)),
        **ptxas_kernels(_build.BUILD_LOG.get("pencil", {}).get("ptxas", []),
                        ("stencil_valid",))}
    ptxas_plan = ptxas_kernels(_build.BUILD_LOG.get("plan", {}).get("ptxas", []),
                               ("build_plan_kernel",))
    ptxas_contract = ptxas_kernels(_build.BUILD_LOG.get("contract", {}).get("ptxas", []),
                                   ("traj_source_kernel", "traj_body_force_kernel"))
    emit("build", seconds=time.perf_counter() - t0, dir=str(_build.build_dir()),
         nvcc={k: v for k, v in _build.BUILD_LOG.items()}, ptxas_k3_k5=ptxas_k3_k5,
         k3_k5_spill_bytes=sum(v.get("spill_stores", 0) + v.get("spill_loads", 0)
                               for v in ptxas_k3_k5.values()),
         ptxas_plan=ptxas_plan,
         plan_spill_bytes=sum(v.get("spill_stores", 0) + v.get("spill_loads", 0)
                              for v in ptxas_plan.values()),
         ptxas_contract=ptxas_contract,
         contract_spill_bytes=sum(v.get("spill_stores", 0) + v.get("spill_loads", 0)
                                  for v in ptxas_contract.values()))

    # 3. kernels vs plain at size^3
    gen = torch.Generator().manual_seed(args.seed)
    f = torch.randn(shape, generator=gen).to(dev)
    stack2 = torch.randn((2,) + shape, generator=gen).to(dev)
    stack3 = torch.randn((3,) + shape, generator=gen).to(dev)
    errs = {}
    checks = []

    def k1_check(label, got, ref):
        err = max_err(got, ref)
        ok = bool(((got - ref).abs() <= K1_ATOL + K1_RTOL * ref.abs()).all())
        checks.append(dict(case=label, max_abs_err=err, ok=ok))
        return err

    errs["stencil_axis:fd8"] = max(
        k1_check(f"fd8 axis {a}", FD8.fd8_partial(f, a),
                 P.stencil_axis_plain(f, a, FD8.FD8_COEFFS, False,
                                      1.0 / (2 * math.pi / n)))
        for a in range(3))

    def prefilter_plain(x):
        for a in range(3):
            x = P.stencil_axis_plain(x, a, PF.PREFILTER_TAPS, True, 1.0)
        return x

    errs["stencil_axis:prefilter"] = max(
        k1_check(f"prefilter K={s.shape[0]}", PF.prefilter3d(s), prefilter_plain(s))
        for s in (stack2, stack3))
    edge_gen = torch.Generator().manual_seed(args.seed + 2)
    k1_modes = {"fd8": (FD8.FD8_COEFFS, False), "prefilter": (PF.PREFILTER_TAPS, True)}
    for shp in K1_EDGE_SHAPES:
        x = torch.randn(shp, generator=edge_gen).to(dev)
        for a in range(3):
            for mode, (taps, sym) in k1_modes.items():
                sc = 1.0 if sym else 1.0 / (2 * math.pi / shp[1 + a])
                key = "stencil_axis:" + mode
                errs[key] = max(errs[key], k1_check(
                    f"{mode} {list(shp)} axis {a}", P.stencil_axis(x, a, taps, sym, sc),
                    P.stencil_axis_plain(x, a, taps, sym, sc)))
        del x

    # K5 at the slab path's shapes: one rank's 264-row extended slab, and a
    # 5-field trajectory stack of the 4-slab layout (72 rows).
    k5_inputs = {"1 rank": torch.randn((n + 8, n, n), generator=gen).to(dev),
                 "4 slabs, 5 fields": torch.randn((5, n // 4 + 8, n, n), generator=gen).to(dev)}
    k5_scale = 1.0 / (2 * math.pi / n)

    def k5_check(label, x, axis):
        got = P.stencil_valid(x, axis, FD8.FD8_COEFFS, k5_scale)
        ref = P.stencil_valid_plain(x, axis, FD8.FD8_COEFFS, k5_scale)
        err = max_err(got, ref)
        tol = K5_REL * max(float(ref.abs().max()), 1.0)
        checks.append(dict(case=f"stencil_valid {label} {list(x.shape)} axis {axis}",
                           max_abs_err=err, tol=tol, ok=err <= tol and got.shape == ref.shape))
        errs["stencil_valid:fd8"] = max(errs.get("stencil_valid:fd8", 0.0), err)

    for label, x in k5_inputs.items():
        k5_check(label, x, 0)
    for axis in range(3):
        for n_loc in K5_EDGE_NLOC:
            shp = [72, 72, 72]
            shp[axis] = n_loc + 2 * len(FD8.FD8_COEFFS)
            k5_check(f"n_loc {n_loc}", torch.randn([3] + shp, generator=edge_gen).to(dev), axis)

    # The matvec's contractions, bit for bit: at size^3 and nt = 4 (the
    # vector path, unrolled), at nt = 1, 6 and 12 (12: the slices in a loop),
    # and on the scalar path: an odd grid, and an adjoint field one element
    # off 16-byte alignment; the body force with and without its a term.
    contract_gen = torch.Generator(device=dev).manual_seed(args.seed + 11)

    def contract_check(label, nt, fshape, misalign=False):
        def rnd(*dims):
            return torch.randn(dims + fshape, generator=contract_gen, device=dev)

        vt_c, grad_c, a_c = rnd(3), rnd(nt + 1, 3), rnd(3)
        lam_c = list(rnd(nt + 1))
        if misalign:
            lam_c[1] = torch.randn(math.prod(fshape) + 1, generator=contract_gen,
                                   device=dev)[1:].view(fshape)
        runs = [("traj_source", "", KC.traj_sources(vt_c, grad_c),
                 KC.traj_sources_plain(vt_c, grad_c))]
        for a, sfx in ((None, ""), (a_c, " + a")):
            runs.append(("traj_body_force", sfx,
                         KC.traj_body_force(lam_c, grad_c, 1.0 / nt, a=a),
                         KC.traj_body_force_plain(lam_c, grad_c, 1.0 / nt, a)))
        for key, sfx, got, ref in runs:
            differ = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            err = max_err(got, ref)
            checks.append(dict(case=f"{key}{sfx} {label} nt={nt} {list(fshape)}",
                               max_abs_err=err, differ=differ,
                               ok=differ == 0 and got.shape == ref.shape))
            errs[key] = max(errs.get(key, 0.0), err)

    contract_check("at the main path's shape", 4, shape)
    for nt in (1, 6, 12):
        contract_check("unrolled" if nt < 12 else "in a loop", nt, (32, 32, 32))
    contract_check("scalar path, odd grid", 4, (33, 17, 5))
    contract_check("scalar path, misaligned adjoint field", 4, (32, 32, 32), misalign=True)

    v_smooth = S.random_velocity(gen, shape, amplitude=0.6, device=dev)
    foot = SL.trace_characteristic(v_smooth, 0.25, "cubic_bspline", 1.0)
    plans = {"": I.build_plan(foot, "cubic_bspline"),
             ":bf16": I.build_plan(foot, "cubic_bspline", bf16)}

    def build_check(label, q, basis, wd, fshape, wrap=(True, True, True)):
        sfx = ":bf16" if wd is not None else ""
        got = I.build_plan(q, basis, wd, shape=fshape, wrap=wrap)
        cmp = plan_differ(got, KP.build_plan_plain(q, basis, wd, tuple(fshape), wrap))
        checks.append(dict(case=f"build_plan {basis}{sfx} {label}", **cmp))
        key = f"build_plan:{basis}{sfx}"
        errs[key] = max(errs.get(key, 0.0), cmp["max_abs_err"])

    # The plan build at the main path's shapes, bit for bit: the footpoints
    # (every basis and weight type), the slab path's clamped field and the
    # multires coarse levels' footpoints (64^3, 128^3)
    for basis in K4_BASES:
        for wd in (None, bf16):
            build_check(f"at the footpoints {list(shape)}", foot, basis, wd, shape)
    coarse_gen = torch.Generator().manual_seed(args.seed + 5)
    for coarse in (64, 128):
        v_c = S.random_velocity(coarse_gen, (coarse,) * 3, amplitude=0.6, device=dev)
        foot_c = SL.trace_characteristic(v_c, 0.25, "cubic_bspline", 1.0)
        for wd in (None, bf16):
            build_check(f"at the footpoints {[coarse] * 3}", foot_c, "cubic_bspline", wd,
                        (coarse,) * 3)
        del v_c, foot_c

    def plan_check(key, label, got, ref):
        err = max_err(got, ref)
        tol = PLAN_REL * max(float(ref.abs().max()), 1.0)
        checks.append(dict(case=label, max_abs_err=err, tol=tol, ok=err <= tol))
        errs[key] = max(errs.get(key, 0.0), err)

    coef1 = PF.prefilter3d(f)
    coef2 = PF.prefilter3d(stack2)
    coef3 = PF.prefilter3d(stack3)
    extra = stack3[0]

    def k3_check(label, coefs, plan, extra_, sfx):
        for epi in ("inc_state", "inc_adjoint"):
            plan_check(f"apply_plan_fused:{epi}{sfx}", f"apply_plan_fused {epi}{sfx} {label}",
                       K.apply_plan_fused(coefs, plan, extra_, epi, 0.25),
                       K.apply_plan_fused_plain(coefs, plan, extra_, epi, 0.25))

    for sfx, plan in plans.items():
        k3_check("at the footpoints", coef2, plan, extra, sfx)
    # K3 on the slab path's plan: one rank's field with SLAB_KW's halo rows
    # on x1 (clamped), gathered at its size^3 interior
    halo = SLAB_KW["halo"]
    slab_foot = torch.stack([foot[0] + halo, foot[1], foot[2]])
    slab_coef = PF.prefilter3d(torch.randn((2, n + 2 * halo, n, n), generator=gen).to(dev))
    for sfx, wd in (("", None), (":bf16", bf16)):
        build_check(f"on the slab field {[n + 2 * halo, n, n]}, x1 clamped", slab_foot,
                    "cubic_bspline", wd, (n + 2 * halo, n, n), (False, True, True))
        slab_plan = I.build_plan(slab_foot, "cubic_bspline", wd, shape=(n + 2 * halo, n, n),
                                 wrap=(False, True, True))
        k3_check(f"on the slab plan {list(slab_coef.shape)}", slab_coef, slab_plan, extra, sfx)
        del slab_plan
    del slab_foot, slab_coef
    # K2 and K4 at each query set, every basis and weight type, K = 1, 2, 3,
    # with the share of K4's cubic blocks that staged their source box (the
    # kernel's diagnostic counter; null on every path)
    box_shares = {}
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    for qname, (fshape, q) in k24_query_sets(foot, args.seed, dev).items():
        if fshape == shape:
            fields = {1: coef1, 2: coef2, 3: coef3}
        else:
            fields = {k: torch.randn((k,) + fshape, generator=gen).to(dev) for k in (1, 2, 3)}
            fields[1] = fields[1][0]
        q_extra = extra if tuple(q.shape[1:]) == shape else torch.randn(
            tuple(q.shape[1:]), generator=gen).to(dev)
        for basis in K4_BASES:
            for sfx, wd in (("", None), (":bf16", bf16)):
                for k, coef in fields.items():
                    plan_check(f"interp3d:{basis}{sfx}", f"interp3d {basis}{sfx} K={k} at {qname}",
                               K.interp3d(coef, q, basis, wd),
                               K.interp3d_plain(coef, q, basis, wd))
                if K.interp3d_tile(basis) == K.TILE_3D_BOX:
                    counter.zero_()
                    K.interp3d(fields[1], q, basis, wd, box_blocks=counter)
                    box_shares[f"interp3d:{basis}{sfx} at {qname}"] = (
                        int(counter.item()) / K.tile_blocks(q.shape[1:], K.TILE_3D_BOX))
                build_check(f"at {qname}", q, basis, wd, fshape)
                plan = I.build_plan(q, basis, wd, shape=fshape)
                for k, coef in fields.items():
                    plan_check("apply_plan" + sfx, f"apply_plan {basis}{sfx} K={k} at {qname}",
                               K.apply_plan(coef, plan), K.apply_plan_plain(coef, plan))
                k3_check(f"{basis} at {qname}", fields[2], plan, q_extra, sfx)
                del plan
        del fields
    box_ok = [box_shares[f"interp3d:{b}{w} at {qname}"] >= 0.9 if qname != "uniform"
              else box_shares[f"interp3d:{b}{w} at uniform"] == 0.0
              for b in K4_BASES if K.interp3d_tile(b) == K.TILE_3D_BOX
              for w in ("", ":bf16") for qname in ("foot", "uniform")]
    checks.append(dict(case="K4 box share >= 0.9 at the footpoints, 0 at uniform queries",
                       ok=all(box_ok)))
    # K6 at its four shapes and at each LM path's own prefill shape; the
    # plain version per head where the whole score tensor would pass
    # PLAIN_SCORES_MAX elements (case d)
    k6_cases = dict(K6_CASES)
    for label, path in LM_PATHS.items():
        cfg = lm_config(path)
        for sfx, bh, s_len, hd, causal in lm_k6_shapes(cfg, path.requests, path.prompt):
            k6_cases[label + sfx] = (bh, s_len, hd, cfg.compute_dtype, (causal,))
    cuda_gen = torch.Generator(device=dev).manual_seed(args.seed)
    k6_inputs = {}
    for label, (bh, s_len, hd, dt, flags) in k6_cases.items():
        qkv = tuple(torch.randn((bh, s_len, hd), generator=cuda_gen, device=dev)
                    .to(getattr(torch, dt)) for _ in range(3))
        k6_inputs[label] = qkv
        for causal in flags:
            got = FA.flash_attention(*qkv, causal=causal)
            if bh * s_len * s_len > PLAIN_SCORES_MAX:
                ref = torch.cat([FA.flash_attention_plain(*(t[h:h + 1] for t in qkv), causal)
                                 for h in range(bh)])
            else:
                ref = FA.flash_attention_plain(*qkv, causal)
            ok, err, differ = k6_close(got, ref, dt)
            checks.append(dict(case=f"flash_attention ({label}) {[bh, s_len, hd]} {dt} "
                                    f"causal={causal}", max_abs_err=err, differ_share=differ,
                               tol=K6_TOL[dt], ok=ok))
            errs["flash_attention"] = max(errs.get("flash_attention", 0.0), err)
            del got, ref
    for hd in (64, 128):
        for bh, s_len in K6_EDGE:
            qkv = tuple(torch.randn((bh, s_len, hd), generator=cuda_gen, device=dev).bfloat16()
                        for _ in range(3))
            for causal in (False, True):
                ok, err, differ = k6_close(FA.flash_attention(*qkv, causal=causal),
                                           FA.flash_attention_plain(*qkv, causal), "bfloat16")
                checks.append(dict(case=f"flash_attention (edge) {[bh, s_len, hd]} bfloat16 "
                                        f"causal={causal}", max_abs_err=err, differ_share=differ,
                                   tol=K6_TOL["bfloat16"], ok=ok))
                errs["flash_attention"] = max(errs["flash_attention"], err)
    # K6 with a query offset: a rank's rows of smollm's sequence-parallel prefill
    bh, s_kv, s_q, hd, offsets = K6_OFFSET
    k6_offset_inputs = {}
    for dt in ("float32", "bfloat16"):
        qkv = tuple(torch.randn((bh, s_kv, hd), generator=cuda_gen, device=dev)
                    .to(getattr(torch, dt)) for _ in range(3))
        k6_offset_inputs[dt] = qkv
        for off in offsets:
            q = qkv[0][:, off:off + s_q].contiguous()
            ok, err, differ = k6_close(
                FA.flash_attention(q, qkv[1], qkv[2], causal=True, q_offset=off),
                FA.flash_attention_plain(q, qkv[1], qkv[2], True, off), dt)
            checks.append(dict(case=f"flash_attention (offset) q {[bh, s_q, hd]} at {off} of "
                                    f"{s_kv} keys {dt} causal=True", max_abs_err=err,
                               differ_share=differ, tol=K6_TOL[dt], ok=ok))
            errs["flash_attention"] = max(errs["flash_attention"], err)
    # the bf16 check must fail faulty plain versions at (a)
    qkv = k6_inputs["a"]
    for fault, causal in (("p_bf16", False), ("p_bf16", True), ("drop_tile", False)):
        seen, err, differ = k6_close(k6_faulty(*qkv, causal, fault),
                                     FA.flash_attention_plain(*qkv, causal), "bfloat16")
        checks.append(dict(case=f"flash_attention (a) control {fault} causal={causal}: "
                                "the check must fail it", max_abs_err=err,
                           differ_share=differ, ok=not seen))
    torch.cuda.synchronize()
    ok3 = all(c["ok"] for c in checks)
    emit("kernels", size=n, ok=ok3, checks=checks, box_shares=box_shares,
         tolerances=dict(k1_rtol=K1_RTOL, k1_atol=K1_ATOL, plan_rel=PLAN_REL,
                         k5_rel=K5_REL, k6=K6_TOL, k6_bf16_differ=K6_BF16_DIFFER))
    if not ok3:
        return 1

    # 4. reference: 16^3 solves on the card vs the plain versions on the CPU
    def ref_entry(card_kw, got, ref, v_rel=REF_V_REL):
        dv = max_err(got.v.cpu(), ref.v)
        vmax = float(ref.v.abs().max())
        pcg_ref = [h["pcg_iters"] for h in ref.history]
        pcg_got = [h["pcg_iters"] for h in got.history]
        return dict(
            card=card_kw, ok=(got.iters == ref.iters and pcg_got == pcg_ref
                              and got.converged == ref.converged and dv <= v_rel * vmax),
            iters=[got.iters, ref.iters], pcg=[pcg_got, pcg_ref], max_abs_dv=dv,
            tol=v_rel * vmax, mismatch_rel=[got.mismatch_rel, ref.mismatch_rel])

    small = S.make_pair(args.seed, (16, 16, 16), device="cpu")
    refs = []
    for kw in (dict(use_fused_matvec=True), dict(use_plan=False)):
        ref = R.register(small.m0, small.m1, device="cpu",
                         use_plan=kw.get("use_plan", True))
        refs.append(ref_entry(kw, R.register(small.m0, small.m1, device=dev, **kw), ref))
    # NCC and NGF on the inverted multimodal pair (NGF capped), fused matvec
    mm16 = S.make_multimodal_pair(args.seed, (16, 16, 16), mode="inverted", device="cpu")
    for kw in (dict(measure="ncc", use_fused_matvec=True),
               dict(measure="ngf", use_fused_matvec=True, max_newton=REF_NGF_MAX_NEWTON)):
        ref = R.register(mm16.m0, mm16.m1, device="cpu", **kw)
        refs.append(ref_entry(kw, R.register(mm16.m0, mm16.m1, device=dev, **kw), ref,
                              REF_NGF_V_REL if kw["measure"] == "ngf" else REF_V_REL))
    # a B = 2 batch: the card's donating step against the CPU's host test
    b16 = S.make_batch(args.seed, (16, 16, 16), 2, device="cpu")
    ref = R.register_batch(b16.m0, b16.m1, use_fused_matvec=True, device="cpu")
    got = R.register_batch(b16.m0, b16.m1, use_fused_matvec=True, donate=True, device=dev)
    pcg_pairs = [[[int(h["pcg_iters"][b]) for h in r.history if h["active"][b]]
                  for b in range(2)] for r in (got, ref)]
    dv = max_err(got.v.cpu(), ref.v)
    vmax = float(ref.v.abs().max())
    refs.append(dict(
        card=dict(batch=2, use_fused_matvec=True, donate=True),
        ok=(got.iters == ref.iters and pcg_pairs[0] == pcg_pairs[1]
            and got.converged == ref.converged and dv <= REF_V_REL * vmax),
        iters=[got.iters, ref.iters], pcg=pcg_pairs, max_abs_dv=dv, tol=REF_V_REL * vmax,
        mismatch_rel=[got.mismatch_rel, ref.mismatch_rel]))
    ok4 = all(r["ok"] for r in refs)
    emit("reference", ok=ok4, runs=refs)
    if not ok4:
        return 1

    # 4b. reference_lm: the smoke config of each LM family with K6's head
    # size 64, the same seeded weights on the card and on the CPU (plain
    # versions there)
    lm_refs = []
    for arch, (b_ref, s_ref) in REF_LM.items():
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(ARCHS[arch].smoke(), param_dtype=dt, compute_dtype=dt)
            if cfg.n_heads:
                cfg = dataclasses.replace(cfg, head_dim=64)
            cpu_card = [build_model(cfg, d).init(torch.Generator().manual_seed(args.seed))
                        for d in ("cpu", dev)]
            batch = cpu_card[0].make_batch(torch.Generator().manual_seed(args.seed + 1),
                                           ShapeConfig("ref", s_ref, b_ref, "prefill"))["batch"]
            tok = batch["tokens"]
            with routing_spy() as routes_cpu:
                runs = [serve_lm.serve(cpu_card[0], batch, 8)]
            counts.reset()
            with routing_spy() as routes_card:
                runs.append(serve_lm.serve(cpu_card[1], batch, 8))
            launched = counts.snapshot()
            pairs = [(runs[1].prefill_logits, runs[0].prefill_logits)]
            caches = [m.make_cache(b_ref, 8) for m in cpu_card]
            for i in range(4):
                ref_l, got_l = (m.decode_step(c, tok[:, i:i + 1], i)[0]
                                for m, c in zip(cpu_card, caches))
                pairs.append((got_l, ref_l))
            errs_l = [max_err(g.float().cpu(), r.float()) for g, r in pairs]
            ids_equal = torch.equal(runs[1].ids.cpu(), runs[0].ids)
            routing_equal = len(routes_card) == len(routes_cpu) and all(
                torch.equal(rc.top_idx.cpu(), r.top_idx) and torch.equal(rc.keep.cpu(), r.keep)
                for rc, r in zip(routes_card, routes_cpu))
            if dt == "float32":
                tols = [LM_FP32_REL * float(r.float().abs().max()) for _, r in pairs]
                ok = ids_equal and routing_equal and all(e <= t for e, t in zip(errs_l, tols))
            else:
                tols = [LM_BF16_ATOL] * len(pairs)
                ok = all(e <= t for e, t in zip(errs_l, tols)) and all(
                    torch.equal(g.float().argmax(-1).cpu(), r.float().argmax(-1))
                    for g, r in pairs[:1])
            k6 = k6_per_prefill(cfg)
            ok = (ok and launched.get("flash_attention", 0) == k6
                  and not any(k.startswith("plain:") for k in launched))
            lm_refs.append(dict(
                arch=arch, family=cfg.family, dtype=dt, head_dim=cfg.head_dim, ok=ok,
                batch={k: list(v.shape) for k, v in batch.items()}, ids_equal=ids_equal,
                id_agreement=float((runs[1].ids.cpu() == runs[0].ids).float().mean()),
                moe_routings=len(routes_card), routing_equal=routing_equal,
                max_logit_err=dict(prefill=errs_l[0], decode=errs_l[1:]), tol=tols[0],
                k6_expected=k6, launches=launched))
            del cpu_card, caches
    ok4 = all(r["ok"] for r in lm_refs)
    emit("reference_lm", ok=ok4, runs=lm_refs)
    if not ok4:
        return 1

    # 5. matvec: plan path vs fused path on one size^3 GradientState
    pair = S.make_pair(args.seed, shape, device=dev)
    beta, gamma = 5e-4, 1e-4
    v = 0.3 * S.random_velocity(gen, shape, device=dev)
    vt = S.random_velocity(gen, shape, amplitude=0.2, device=dev)
    cfg = R.make_transport_config("fd8-cubic")
    cfg_f = R.make_transport_config("fd8-cubic", use_fused_matvec=True)
    gs = GR.evaluate(pair.m0, pair.m1, v, beta, gamma, cfg)
    hv_plan = HS.matvec(vt, gs, v, beta, gamma, cfg)
    hv_fused = HS.matvec(vt, gs, v, beta, gamma, cfg_f)
    scale = float(hv_plan.abs().max())
    dev_mv = max_err(hv_fused, hv_plan)
    ok5 = bool(math.isfinite(scale)) and dev_mv <= MATVEC_REL * max(scale, 1.0)
    emit("matvec", ok=ok5, max_abs_dev=dev_mv, scale=scale,
         tol=MATVEC_REL * max(scale, 1.0))
    if not ok5:
        return 1
    del gs, hv_plan, hv_fused, v, vt

    # 6-17. the paths, each with every count set to 0 just before it
    path_launches = {}

    def drive(label, required, run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The script's own tensors (inputs, plans of the kernels phase) are
        # live throughout: the path's peak above them is the difference.
        before = torch.cuda.memory_allocated()
        counts.reset()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.snapshot()
        path_launches[label] = launches
        fields = dict(wall_s=wall, max_memory_allocated=torch.cuda.max_memory_allocated(),
                      memory_allocated_before=before, launches=launches,
                      missing=[k for k in required if launches.get(k, 0) == 0],
                      plain_runs={k: c for k, c in launches.items()
                                  if k.startswith("plain:")})
        return out, fields

    def solved(res):
        return (math.isfinite(res.mismatch_rel) and res.detF["min"] > 0
                and bool(torch.isfinite(res.v).all())
                and tuple(res.v.shape) == (3,) + shape)

    def solve_fields(res):
        return dict(iters=res.iters, pcg_per_step=[h["pcg_iters"] for h in res.history],
                    ls_evals=[h["ls_evals"] for h in res.history], matvecs=res.matvecs,
                    mismatch_rel=res.mismatch_rel, detF=res.detF,
                    converged=res.converged, rel_grad=res.rel_grad,
                    solver_wall_s=res.wall_time_s)

    walls = {}
    for label, (kw, required) in PATHS.items():
        res, fields = drive(label, required,
                            lambda kw=kw: R.register(pair.m0, pair.m1, device=dev, **kw))
        ok = solved(res) and not fields["missing"] and not fields["plain_runs"]
        walls[label] = fields.pop("wall_s")
        emit(label, ok=ok, size=n, **kw, **solve_fields(res),
             register_wall_s=walls[label], **fields)
        if not ok:
            return 1
        if label == "solve":
            solve_ref = dict(v=res.v, iters=res.iters,
                             pcg=[h["pcg_iters"] for h in res.history],
                             gnorm=[h["gnorm"] for h in res.history])
        if label == "solve_planfree":
            cfg_pf = R.make_transport_config(**kw)
            warped, lf = drive("warp_labels", ["interp3d:linear"],
                               lambda v_=res.v: M.warp_labels(pair.labels0, v_, cfg_pf))
            d = float(M.dice(warped, pair.labels1))
            d0 = float(M.dice(pair.labels0, pair.labels1))
            ok = (math.isfinite(d) and not lf["missing"] and not lf["plain_runs"]
                  and tuple(warped.shape) == shape)
            emit("warp_labels", ok=ok, dice=d, dice_unregistered=d0, **lf)
            if not ok:
                return 1
        del res

    mres, fields = drive("multires", _K1_KEYS + ["apply_plan"] + _FUSED + _CONTRACTIONS,
                         lambda: R.register_multires(pair.m0, pair.m1, variant="fd8-cubic",
                                                     n_levels=3, use_fused_matvec=True,
                                                     device=dev))
    ok = solved(mres) and not fields["missing"] and not fields["plain_runs"]
    wall = fields.pop("wall_s")
    emit("multires", ok=ok, size=n, levels=mres.levels,
         level_iters=[lr.iters for lr in mres.level_results],
         level_matvecs=[lr.matvecs for lr in mres.level_results],
         level_wall_s=[lr.wall_time_s for lr in mres.level_results],
         level_converged=[lr.converged for lr in mres.level_results],
         iters=mres.iters, fine_iters=mres.fine_iters, matvecs=mres.matvecs,
         mismatch_rel=mres.mismatch_rel, detF=mres.detF, converged=mres.converged,
         solver_wall_s=mres.wall_time_s, register_wall_s=wall, **fields)
    if not ok:
        return 1
    del mres

    for label, (kw, required) in VARIANT_PATHS.items():
        res, fields = drive(label, required,
                            lambda kw=kw: R.register(pair.m0, pair.m1, max_newton=2,
                                                     device=dev, **kw))
        ok = solved(res) and not fields["missing"] and not fields["plain_runs"]
        wall = fields.pop("wall_s")
        emit(label, ok=ok, size=n, max_newton=2, **kw, **solve_fields(res),
             register_wall_s=wall, **fields)
        if not ok:
            return 1
        del res

    # the slab-parallel path on a one-rank NCCL group
    with slab_group(dev):
        res, fields = drive("solve_slab", SLAB_REQUIRED,
                            lambda: R.register_sharded(pair.m0, pair.m1, device=dev,
                                                       **SLAB_KW))
    pcg = [h["pcg_iters"] for h in res.history]
    dv = max_err(res.v, solve_ref["v"])
    tol = SLAB_V_REL * float(solve_ref["v"].abs().max())
    ok = (solved(res) and not fields["missing"] and not fields["plain_runs"]
          and res.iters == solve_ref["iters"] and pcg == solve_ref["pcg"] and dv <= tol)
    walls["solve_slab"] = fields.pop("wall_s")
    emit("solve_slab", ok=ok, size=n, ranks=1, backend="nccl", **SLAB_KW,
         **solve_fields(res), register_wall_s=walls["solve_slab"],
         solve_iters=solve_ref["iters"], solve_pcg_per_step=solve_ref["pcg"],
         max_abs_dv_vs_solve=dv, tol=tol, **fields)
    if not ok:
        return 1
    del res

    # NCC through the facade (single mode, its Dice through warp_labels) and
    # NGF through register, on the contrast-inverted pair
    mm = S.make_multimodal_pair(args.seed, shape, mode="inverted", device=dev)
    problem = API.RegistrationProblem(m0=mm.m0, m1=mm.m1, labels0=mm.labels0,
                                      labels1=mm.labels1)
    opts = API.SolverOptions(measure="ncc", use_fused_matvec=True, mode="single")
    res, fields = drive("solve_ncc", NCC_REQUIRED, lambda: API.Solver(opts).solve(problem))
    ok = (solved(res) and not fields["missing"] and not fields["plain_runs"]
          and res.dice_after is not None and math.isfinite(res.dice_after))
    emit("solve_ncc", ok=ok, size=n, entry="repro_torch.api.Solver", options=opts.to_dict(),
         iters=res.iters, matvecs=res.matvecs, converged=res.converged,
         rel_grad=res.rel_grad, mismatch_rel=res.mismatch_rel, detF=res.detF,
         dice_before=res.dice_before, dice_after=res.dice_after,
         solver_wall_s=res.wall_time_s, register_wall_s=fields.pop("wall_s"), **fields)
    if not ok:
        return 1
    del res
    ngf_kw = dict(measure="ngf", use_fused_matvec=True, max_newton=NGF_MAX_NEWTON)
    res, fields = drive("solve_ngf", PLAN_FUSED,
                        lambda: R.register(mm.m0, mm.m1, device=dev, **ngf_kw))
    fd8 = fields["launches"].get("stencil_axis:fd8", 0)
    # det F is reported, not gated: three NGF steps fold this pair's map at
    # 256^3 (PERF.md §6)
    ok = (math.isfinite(res.mismatch_rel) and bool(torch.isfinite(res.v).all())
          and tuple(res.v.shape) == (3,) + shape and all(
              math.isfinite(h["j"]) for h in res.history)
          and not fields["missing"] and not fields["plain_runs"] and fd8 >= 6 * res.matvecs)
    emit("solve_ngf", ok=ok, size=n, **ngf_kw,
         **solve_fields(res), fd8_launches=fd8, fd8_per_matvec_min=6,
         register_wall_s=fields.pop("wall_s"), **fields)
    if not ok:
        return 1
    del res, mm, problem

    # a B = 2 batch (pair 0 is the solve path's pair), donating step
    batch = S.make_batch(args.seed, shape, 2, device=dev)
    bres, fields = drive("batch", PLAN_FUSED,
                         lambda: R.register_batch(batch.m0, batch.m1, use_fused_matvec=True,
                                                  donate=True, device=dev))

    def pair_pcg(r):
        return [[int(h["pcg_iters"][b]) for h in r.history if h["active"][b]]
                for b in range(len(r.iters))]

    def batch_solved(r):
        return (all(d["min"] > 0 for d in r.detF)
                and all(math.isfinite(m) for m in r.mismatch_rel)
                and bool(torch.isfinite(r.v).all()) and tuple(r.v.shape) == (2, 3) + shape)

    dv = max_err(bres.v[0], solve_ref["v"])
    tol = BATCH_V_REL * float(solve_ref["v"].abs().max())
    ok = (batch_solved(bres) and not fields["missing"] and not fields["plain_runs"]
          and bres.iters[0] == solve_ref["iters"] and pair_pcg(bres)[0] == solve_ref["pcg"]
          and dv <= tol)
    emit("batch", ok=ok, size=n, batch=2, use_fused_matvec=True, donate=True,
         iters=bres.iters, pcg_per_step=pair_pcg(bres), matvecs=bres.matvecs,
         converged=bres.converged, mismatch_rel=bres.mismatch_rel, detF=bres.detF,
         solver_wall_s=bres.wall_time_s, register_wall_s=fields.pop("wall_s"),
         solve_iters=solve_ref["iters"], solve_pcg_per_step=solve_ref["pcg"],
         max_abs_dv_pair0_vs_solve=dv, tol=tol, **fields)
    if not ok:
        return 1

    # the same batch on a 1 x 1 ensemble x slab layout of the one-rank group
    with slab_group(dev):
        layout = G.ensemble_slab_groups(1, 1)
        eres, fields = drive("ensemble_slab", SLAB_REQUIRED,
                             lambda: R.register_sharded(batch.m0, batch.m1, group=layout,
                                                        device=dev, **SLAB_KW))
    dv = max_err(eres.v, bres.v)
    tol = SLAB_V_REL * float(bres.v.abs().max())
    ok = (batch_solved(eres) and not fields["missing"] and not fields["plain_runs"]
          and eres.iters == bres.iters and eres.matvecs == bres.matvecs
          and pair_pcg(eres) == pair_pcg(bres) and dv <= tol)
    emit("ensemble_slab", ok=ok, size=n, layout=layout.sizes(), backend="nccl",
         **SLAB_KW, iters=eres.iters, pcg_per_step=pair_pcg(eres),
         matvecs=eres.matvecs, converged=eres.converged, mismatch_rel=eres.mismatch_rel,
         detF=eres.detF, solver_wall_s=eres.wall_time_s,
         register_wall_s=fields.pop("wall_s"), batch_iters=bres.iters,
         max_abs_dv_vs_batch=dv, tol=tol, **fields)
    if not ok:
        return 1
    del eres

    # the registration CLI, in process
    config = f"claire_{n}"
    argv = (["--config", config] if config in REGISTRATIONS else ["--grid", str(n)]) + [
        "--device", "cuda"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, fields = drive("cli", _K1_KEYS + ["apply_plan"] + _CONTRACTIONS, lambda: CLI.main(argv))
    lines = out.getvalue().splitlines()
    ok = (rc == 0 and not fields["missing"] and not fields["plain_runs"]
          and any("converged=" in ln for ln in lines))
    emit("cli", ok=ok, argv=argv, rc=rc, output=lines, wall_s=fields.pop("wall_s"),
         **fields)
    if not ok:
        return 1

    # the gradient-descent baseline (Table 8), five iterations
    gd, fields = drive("baseline_gd", _K1_KEYS + ["apply_plan", "traj_body_force"],
                       lambda: BGD.solve(pair.m0, pair.m1, R.make_transport_config("fd8-cubic"),
                                         max_iters=5))
    ok = (not fields["missing"] and not fields["plain_runs"] and len(gd.history) >= 1
          and bool(torch.isfinite(gd.v).all()) and gd.gnorm < gd.gnorm0)
    emit("baseline_gd", ok=ok, size=n, variant="fd8-cubic", max_iters=5, iters=gd.iters,
         gnorm_history=[h["gnorm"] for h in gd.history],
         gn_gnorm_history=solve_ref["gnorm"], rel_grad=gd.rel_grad,
         solver_wall_s=gd.wall_time_s, wall_s=fields.pop("wall_s"), **fields)
    if not ok:
        return 1
    del gd

    # the registration server on the batch's pairs, as numpy arrays (what a
    # server receives): three rounds, each waited on
    pairs = [(batch.m0[b].cpu().numpy(), batch.m1[b].cpu().numpy()) for b in range(2)]
    drift_cfg = TR.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=4)
    m1_drift = TR.solve_state(batch.m0[1], 0.9 * batch.v_true[1], drift_cfg)[-1].cpu().numpy()
    del batch
    rounds = [[(pairs[0], "A"), (pairs[1], "B")],
              [(pairs[0], "A"), ((pairs[1][0], m1_drift), "B")],
              [(pairs[0], None)]]

    def serve(config, rnds):
        out = []
        with SV.Server(config) as srv:
            for rnd in rnds:
                futs = [srv.submit(SV.Request(m0=m0, m1=m1, subject=subj))
                        for (m0, m1), subj in rnd]
                out.append([fut.result(timeout=600) for fut in futs])
        return out, srv.summary(), list(srv.stats.waves)

    def request_fields(r):
        return dict(subject=r.subject, iters=r.iters, matvecs=r.matvecs,
                    converged=r.converged, warm_started=r.warm_started,
                    cache_visits=r.cache_visits, gnorm0=r.gnorm0, rel_grad=r.rel_grad,
                    mismatch_rel=r.mismatch_rel, wave=[r.wave_id, r.wave_real, r.wave_padded],
                    latency_s=r.latency_s, queue_s=r.queue_s, solve_s=r.solve_s,
                    collect_s=r.collect_s)

    def wave_fields(waves):
        return [{k: w[k] for k in ("wave_id", "real", "padded", "iters", "warm",
                                   "assemble_s", "solve_s", "collect_s")} for w in waves]

    def dv_rel(r, b, v_ref):
        ref_b = v_ref[b].cpu()
        return max_err(torch.from_numpy(r.v), ref_b) / float(ref_b.abs().max())

    def cold_round_ok(rnd, v_ref, v_rel):
        return all(r.iters == bres.iters[b] and r.matvecs == bres.matvecs[b]
                   and not r.warm_started and (r.wave_real, r.wave_padded) == (2, 2)
                   and dv_rel(r, b, v_ref) <= v_rel for b, r in enumerate(rnd))

    with tempfile.TemporaryDirectory(prefix="serve_cache_") as cache_dir:
        serve_cfg = SV.ServeConfig(max_batch=2, use_fused_matvec=True, cache_dir=cache_dir,
                                   device="cuda")
        (got, summary, waves), fields = drive("serve", PLAN_FUSED,
                                              lambda: serve(serve_cfg, rounds))
        cold, warm, part = got
        a_step = CK.latest_step(f"{cache_dir}/A")
        reload = SV.WarmStartCache(cache_dir).lookup("A", shape)
        reload_equal = reload is not None and np.array_equal(reload.v0, warm[0].v)
    ok = (not fields["missing"] and not fields["plain_runs"]
          and cold_round_ok(cold, bres.v, SERVE_V_REL)
          and warm[0].warm_started and warm[0].cache_visits == 1
          and abs(warm[0].gnorm0 - cold[0].gnorm0) <= SERVE_GNORM_REL * cold[0].gnorm0
          and warm[0].iters < cold[0].iters and warm[0].converged
          and warm[1].warm_started and warm[1].cache_visits == 1 and warm[1].converged
          and (part[0].wave_real, part[0].wave_padded) == (1, 2)
          and (part[0].iters, part[0].matvecs) == (cold[0].iters, cold[0].matvecs)
          and not part[0].warm_started
          and all(np.isfinite(r.v).all() and r.v.shape == (3,) + shape
                  for rnd in got for r in rnd)
          and (summary["completed"], summary["failed"], summary["warm_hits"],
               summary["waves"]) == (5, 0, 2, 3)
          and a_step == 2 and reload_equal)
    emit("serve", ok=ok, size=n, config=dict(max_batch=2, use_fused_matvec=True,
                                             cache="checkpointed, async", device="cuda"),
         rounds=[[request_fields(r) for r in rnd] for rnd in got], waves=wave_fields(waves),
         batch_iters=bres.iters, batch_matvecs=bres.matvecs,
         cold_max_dv_rel=[dv_rel(r, b, bres.v) for b, r in enumerate(cold)],
         tol_v_rel=SERVE_V_REL, latency_p50_s=summary["latency_p50_s"],
         latency_p99_s=summary["latency_p99_s"], pairs_per_sec=summary["pairs_per_sec"],
         utilization_mean=summary["utilization_mean"],
         iters_mean_warm=summary["iters_mean_warm"],
         iters_mean_cold=summary["iters_mean_cold"], summary=summary,
         checkpoint_latest_step_A=a_step, checkpoint_reload_bit_equal=reload_equal,
         solve_path_wall_s=walls["solve"], serve_wall_s=fields.pop("wall_s"), **fields)
    if not ok:
        return 1

    # the cold round through the mesh mode on a 1 x 1 layout of one NCCL rank
    with slab_group(dev):
        layout = G.ensemble_slab_groups(1, 1)
        slab_cfg = SV.ServeConfig(max_batch=2, use_fused_matvec=True, mesh=layout,
                                  device="cuda")
        (sgot, ssummary, swaves), fields = drive("serve_slab", SLAB_REQUIRED,
                                                 lambda: serve(slab_cfg, rounds[:1]))
    ok = (not fields["missing"] and not fields["plain_runs"]
          and cold_round_ok(sgot[0], bres.v, SLAB_V_REL)
          and (ssummary["completed"], ssummary["failed"]) == (2, 0))
    emit("serve_slab", ok=ok, size=n, layout=layout.sizes(), backend="nccl",
         round=[request_fields(r) for r in sgot[0]], waves=wave_fields(swaves),
         max_dv_rel_vs_batch=[dv_rel(r, b, bres.v) for b, r in enumerate(sgot[0])],
         tol_v_rel=SLAB_V_REL, serve_wall_s=fields.pop("wall_s"), **fields)
    if not ok:
        return 1
    serve_cold_wall = max(r.latency_s for r in cold)
    del bres, got, sgot

    # the registration serving launcher, in process
    argv = ["--smoke", "--device", "cuda"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, fields = drive("serve_cli", _K1_KEYS + ["apply_plan"] + _CONTRACTIONS, lambda: SCLI.main(argv))
    lines = out.getvalue().splitlines()
    ok = (rc == 0 and not fields["missing"] and not fields["plain_runs"]
          and any("completed 6/6" in ln for ln in lines))
    emit("serve_cli", ok=ok, argv=argv, rc=rc, output=lines, wall_s=fields.pop("wall_s"),
         **fields)
    if not ok:
        return 1

    # the LM serving paths at full width, random seeded weights
    lm_walls = {}
    new_lm_s = 0.0
    for label, path in LM_PATHS.items():
        t_path = time.perf_counter()
        cfg = lm_config(path)
        b, p_len, g = path.requests, path.prompt, path.gen
        gen_w = (torch.Generator(device=dev) if path.init_on == "cuda"
                 else torch.Generator()).manual_seed(args.seed)
        t0 = time.perf_counter()
        model = build_model(cfg, dev).init(gen_w)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        lm_batch = model.make_batch(torch.Generator().manual_seed(args.seed + 1),
                                    ShapeConfig("serve", p_len, b, "prefill"))["batch"]
        warm = model.make_batch(torch.Generator().manual_seed(args.seed + 2),
                                ShapeConfig("warm", 128 + cfg.n_patches, b, "prefill"))["batch"]
        serve_lm.serve(model, warm, 2)  # warm-up (cuBLAS), not counted
        res, fields = drive(label, ["flash_attention"] if path.k6 else [],
                            lambda: serve_lm.serve(model, lm_batch, g))
        lg = res.prefill_logits
        k6 = fields["launches"].get("flash_attention", 0)
        ok = (k6 == path.k6 == k6_per_prefill(cfg) and not fields["missing"]
              and not fields["plain_runs"]
              and tuple(res.ids.shape) == (b, g + 1)
              and tuple(lg.shape) == (b, 1, cfg.vocab_padded)
              and bool(torch.isfinite(lg.float()).all())
              and 0 <= int(res.ids.min()) and int(res.ids.max()) < cfg.vocab_padded)
        wall = fields.pop("wall_s")
        moe_fields = {}
        if cfg.n_experts:
            # one more prefill: capacity drops over every MoE layer's
            # (token, choice) pairs
            with routing_spy() as routes:
                model.prefill(lm_batch)
            moe_fields["moe_drop_share"] = (sum(int((~r.keep).sum()) for r in routes)
                                            / sum(r.keep.numel() for r in routes))
            moe_fields["moe_layers_routed"] = len(routes)
            del routes
        emit(label, ok=ok, arch=path.arch, family=cfg.family, n_layers=cfg.n_layers,
             reduced={k: [getattr(ARCHS[path.arch], k), v] for k, v in path.reduced.items()},
             d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
             head_dim=cfg.head_dim, n_experts=cfg.n_experts, top_k=cfg.top_k,
             vocab_padded=cfg.vocab_padded, dtype=cfg.compute_dtype,
             params=sum(t.numel() for t in model.state_dict().values()),
             weights_init_on=path.init_on, requests=b, prompt_len=p_len, gen_len=g,
             batch={k: list(v.shape) for k, v in lm_batch.items()}, init_s=init_s,
             serve_wall_s=wall, prefill_s=res.prefill_s, prefill_tok_s=b * p_len / res.prefill_s,
             decode_s=res.decode_s, decode_tok_s=b * g / res.decode_s,
             k6_launches_per_prefill=k6, k6_expected=path.k6,
             ids_first_request=res.ids[0].tolist(), **moe_fields, **fields)
        if not ok:
            return 1
        if label in SERVE_SHARDED:
            with slab_group(dev):
                sharded = serve_sharded(model, lm_batch, res, g, path.k6, drive,
                                        SERVE_SHARDED[label])
            emit(SERVE_SHARDED[label], arch=path.arch, **sharded)
            if not sharded["ok"]:
                return 1
        lm_walls[label] = (res.prefill_s, res.decode_s)
        if path.arch == "qwen1.5-0.5b":
            lm_keep = (model, lm_batch, g)
        if path.arch == "deepseek-moe-16b":
            # profiled here and printed in phase profile: the model does not
            # stay on the card beside the next ones
            moe_profiles = profile_moe(model, lm_batch, p_len, g, res)
        del model, res, lm_batch, warm
        torch.cuda.empty_cache()
        if path.init_on == "cuda":
            new_lm_s += time.perf_counter() - t_path

    # train_parity: one fp32 train step of each family's smoke config on the
    # card and on the CPU, from the same weights and batch
    t_train = time.perf_counter()
    ocfg = AdamWConfig(lr=3e-4, total_steps=6, warmup_steps=1)
    parity = []
    for family, arch in TRAIN_PARITY.items():
        cfg = dataclasses.replace(ARCHS[arch].smoke(), param_dtype="float32",
                                  compute_dtype="float32")
        runs = []
        for d in ("cpu", dev):
            model = build_model(cfg, d)
            state = TS.init_train_state(model, torch.Generator().manual_seed(args.seed), ocfg)
            batch = next(TL.token_batches(model, 64, 2, seed=args.seed))
            counts.reset()
            with grads_spy() as seen:
                new, met = TS.make_train_step(model, None, ocfg)(state, batch)
            runs.append((state, new, met, seen[0], counts.snapshot()))
        (s0, n0, m0, g0, _), (_, n1, m1, g1, launched) = runs
        loss_dev = abs(float(m1["loss"]) - float(m0["loss"])) / abs(float(m0["loss"]))
        gnorm_dev = abs(float(m1["grad_norm"]) - float(m0["grad_norm"])) / float(m0["grad_norm"])
        grad_dev = max(max_err(a.cpu().float(), b.float()) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(OPT.leaves(g1), OPT.leaves(g0)))
        g1_cpu = OPT.unflatten(g1, [t.cpu() for t in OPT.leaves(g1)])
        ref_p, ref_o, _ = OPT.adamw_update(ocfg, g1_cpu, s0.opt, s0.params)
        upd_dev = max(update_dev(n1.params, ref_p),
                      *(update_dev(n1.opt[k], ref_o[k]) for k in ("m", "v", "master")))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in OPT.leaves(n1.params))
        ok = (loss_dev <= TRAIN_LOSS_REL and gnorm_dev <= TRAIN_GRAD_REL
              and grad_dev <= TRAIN_GRAD_REL and upd_dev <= TRAIN_UPDATE_REL and finite
              and not launched)
        parity.append(dict(
            family=family, arch=arch, ok=ok, dtype="float32", batch=[2, 64],
            loss=[float(m0["loss"]), float(m1["loss"])], loss_rel_dev=loss_dev,
            grad_norm=[float(m0["grad_norm"]), float(m1["grad_norm"])],
            grad_norm_rel_dev=gnorm_dev, grad_leaf_rel_dev=grad_dev, update_dev=upd_dev,
            params_dev_over_lr=max(max_err(a.cpu().float(), b.float()) for a, b in zip(
                OPT.leaves(n1.params), OPT.leaves(n0.params))) / ocfg.lr,
            launches_on_card=launched))
        del runs, s0, n0, n1, g0, g1
    ok = all(r["ok"] for r in parity)
    emit("train_parity", ok=ok, runs=parity,
         tol=dict(loss_rel=TRAIN_LOSS_REL, grad_rel=TRAIN_GRAD_REL,
                  update_rel=TRAIN_UPDATE_REL))
    if not ok:
        return 1

    # train:smollm-135m at published width through the launcher's Trainer
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_a, ckpt_b = pathlib.Path(tmp, "a"), pathlib.Path(tmp, "b")
        trainer, batches = TL.make_trainer(TRAIN_ARGV + ["--ckpt-dir", str(ckpt_a)])
        cfg, tokens_per_step = trainer.model.cfg, 8 * 2048
        saved, save = {}, trainer.ckpt.save

        def save_spy(tree, step):
            saved[step] = tree  # the state the trainer saved, kept on the card
            save(tree, step)

        trainer.ckpt.save = save_spy
        state, fields = drive("train:smollm-135m", [], lambda: trainer.run(
            batches, torch.Generator().manual_seed(args.seed)))
        log = trainer.metrics_log
        # 6 N D model FLOPs a step (N = 134.5 M params, D = 8 x 2048 tokens)
        step_flops = model_flops(cfg, ShapeConfig("train", 2048, 8, "train"))
        steps = [dict(step=m["step"], loss=m["loss"], grad_norm=m["grad_norm"], lr=m["lr"],
                      step_s=m["step_time_s"], tokens_s=tokens_per_step / m["step_time_s"],
                      mfu=step_flops / (m["step_time_s"] * PEAK_BF16_FLOPS))
                 for m in log]
        steady = sorted(m["step_time_s"] for m in log[1:])
        steady_s = steady[len(steady) // 2]
        train_wall = fields.pop("wall_s")
        ok = (len(log) == 6 and int(state.opt["step"]) == 6 and sorted(saved) == [3, 6]
              and all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in log)
              and log[-1]["loss"] < log[0]["loss"]
              and not fields["plain_runs"] and "flash_attention" not in fields["launches"])
        # the restart: a new trainer restored from the step-3 checkpoint
        ckpt_b.mkdir()
        shutil.copytree(ckpt_a / "step_00000003", ckpt_b / "step_00000003")
        trainer_b, _ = TL.make_trainer(TRAIN_ARGV + ["--ckpt-dir", str(ckpt_b)])
        t0 = time.perf_counter()
        trainer_b.init_or_restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_equal = tree_bits_equal([trainer_b.state.params, trainer_b.state.opt],
                                         [saved[3].params, saved[3].opt])
        start_b = trainer_b.start_step
        resumed = TL.token_batches(trainer_b.model, 2048, 8)
        for _ in range(3):
            next(resumed)
        state_b = trainer_b.run(resumed)
        log_b = trainer_b.metrics_log
        restart_ok = (start_b == 3 and restored_equal and int(state_b.opt["step"]) == 6
                      and [m["step"] for m in log_b] == [4, 5, 6]
                      and all(math.isfinite(m["loss"]) for m in log_b))
        emit("train:smollm-135m", ok=ok and restart_ok, arch="smollm-135m",
             n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
             n_kv_heads=cfg.n_kv_heads, vocab_padded=cfg.vocab_padded,
             param_dtype=cfg.param_dtype, argv=TRAIN_ARGV,
             params=sum(t.numel() for t in OPT.leaves(state.params)),
             tokens_per_step=tokens_per_step, steps=steps, steady_step_s=steady_s,
             steady_tokens_s=tokens_per_step / steady_s, run_wall_s=train_wall,
             model_flops_per_step=step_flops,
             steady_mfu=step_flops / (steady_s * PEAK_BF16_FLOPS),
             mfu_note="model_flops (6 N D) / (step_s x the bf16 dense peak, 989 TFLOP/s)",
             peak_gb_less_script=(fields["max_memory_allocated"]
                                  - fields["memory_allocated_before"]) / 1e9,
             launches_note="counted over the whole run, recomputation in backward "
                           "included; the train path launches no kernel (K6 has no "
                           "backward: attention is the blockwise PyTorch version)",
             restart=dict(ok=restart_ok, start_step=start_b, restored_equal=restored_equal,
                          restore_s=restore_s, final_step=int(state_b.opt["step"]),
                          losses=[m["loss"] for m in log_b],
                          step6_loss_continuous=log[-1]["loss"],
                          params_max_dev_vs_continuous=max(
                              max_err(a.float(), b.float()) for a, b in zip(
                                  OPT.leaves(state_b.params), OPT.leaves(state.params)))),
             **fields)
        if not (ok and restart_ok):
            return 1
        train_phase_peak = fields["max_memory_allocated"] - fields["memory_allocated_before"]
        del trainer_b, state_b
        torch.cuda.empty_cache()
        with slab_group(dev):
            sharded = train_sharded(TL, saved[3], log[:3], ckpt_a, pathlib.Path(tmp), drive,
                                    args.seed)
            emit("train_sharded:smollm-135m", **sharded)
            if not sharded["ok"]:
                return 1
            comp = compression_phase(dev, args.seed)
            emit("compression", **comp)
            if not comp["ok"]:
                return 1
        # one more step under the profiler, printed in phase profile
        del saved
        prof_batch = next(TL.token_batches(trainer.model, 2048, 8, seed=args.seed + 1))
        with train_ranges(trainer.model):
            train_profile = profile("train:smollm-135m step",
                                    lambda: trainer.step_fn(state, prof_batch), steady_s)
        # for phase dryrun: one more step's peak above its arguments (the
        # state and the batch), and one more under FlopCounterMode
        train_measured = measure_step(lambda: trainer.step_fn(state, prof_batch),
                                      nbytes(*OPT.leaves([state.params, state.opt]))
                                      + nbytes(*prof_batch.values()))
        train_measured.update(steady_step_s=steady_s, phase_peak_above_script=train_phase_peak)
        del trainer, state, batches, prof_batch
        torch.cuda.empty_cache()
    train_s = time.perf_counter() - t_train

    # ensemble_step:claire_256: the dry-run's registration cell on two pairs
    t_new = time.perf_counter()
    rcfg = REGISTRATIONS["claire_256_ensemble"]
    ens_cfg = TR.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=rcfg.nt)
    ens_gn = GN.GNConfig(**DR.GN_CELL)
    pairs = S.make_batch(args.seed, shape, ENSEMBLE_PAIRS, device=dev)
    v0 = torch.zeros((ENSEMBLE_PAIRS, 3) + shape, device=dev)
    eta = ens_gn.forcing_max
    ens_step = CD.ensemble_newton_step(ens_cfg, ens_gn)
    ens_step(pairs.m0, pairs.m1, v0, rcfg.beta, rcfg.gamma, eta)  # warm-up (cuFFT plans)
    est, fields = drive("ensemble_step:claire_256", ENSEMBLE_REQUIRED,
                        lambda: ens_step(pairs.m0, pairs.m1, v0, rcfg.beta, rcfg.gamma, eta))
    ens_wall = fields.pop("wall_s")
    ens_peak = fields["max_memory_allocated"] - fields["memory_allocated_before"]
    one_step = GN.make_step(ens_cfg, ens_gn)
    pair_equal = []
    for b in range(ENSEMBLE_PAIRS):
        r = one_step(pairs.m0[b], pairs.m1[b], v0[b], rcfg.beta, rcfg.gamma, eta)
        pair_equal.append(
            torch.equal(est.v_new[b], r.v_new) and int(est.pcg_iters[b]) == r.pcg_iters
            and int(est.ls_evals[b]) == r.ls_evals
            and all(torch.equal(getattr(est, k)[b], torch.as_tensor(getattr(r, k)))
                    for k in GN._SCALARS))
    ok = (all(pair_equal) and not fields["missing"] and not fields["plain_runs"]
          and bool(torch.isfinite(est.v_new).all())
          and tuple(est.v_new.shape) == (ENSEMBLE_PAIRS, 3) + shape)
    emit("ensemble_step:claire_256", ok=ok, size=n, pairs=ENSEMBLE_PAIRS, gn=DR.GN_CELL,
         transport=dict(interp=ens_cfg.interp, deriv=ens_cfg.deriv, nt=ens_cfg.nt),
         pcg_iters=est.pcg_iters.tolist(), ls_evals=est.ls_evals.tolist(),
         gnorm=est.gnorm.tolist(), alpha=est.alpha.tolist(), pairs_bit_equal=pair_equal,
         step_wall_s=ens_wall, per_pair_s=ens_wall / ENSEMBLE_PAIRS,
         peak_gb_less_script=ens_peak / 1e9, **fields)
    if not ok:
        return 1
    ens_args = nbytes(pairs.m0, pairs.m1, v0)
    ens_counts = (est.pcg_iters.tolist(), est.ls_evals.tolist())
    del est, pairs, v0

    # dryrun: the qwen1.5-0.5b prefill's peak and FLOPs on the card, then the
    # predictions (in this process, no device) beside the examples and the
    # dry-run records (subprocesses)
    model, lm_batch, g = lm_keep
    weights_bytes = nbytes(*model.state_dict().values())
    prefill_measured = measure_step(lambda: model.prefill(lm_batch),
                                    weights_bytes + nbytes(*lm_batch.values()))
    prefill_measured.update(
        prefill_s=lm_walls["serve_lm:qwen1.5-0.5b"][0],
        k6_launches=path_launches["serve_lm:qwen1.5-0.5b"].get("flash_attention", 0))
    one_rank = ((1, 1), ("data", "model"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_side, predict_pool(3) as pool:
        futures = dict(
            train=pool.submit(DR.lm_cell, ARCHS["smollm-135m"],
                              ShapeConfig("train", 2048, 8, "train"), *one_rank),
            prefill=pool.submit(DR.lm_cell, lm_config(LM_PATHS["serve_lm:qwen1.5-0.5b"]),
                                ShapeConfig("prefill", 2048, 8, "prefill"), *one_rank),
            ensemble=pool.submit(DR.claire_cell, dataclasses.replace(
                rcfg, grid=shape, ensemble=ENSEMBLE_PAIRS), "ensemble", *one_rank))
        side = start_side_runs(pathlib.Path(tmp_side))
        try:
            preds = {k: f.result() for k, f in futures.items()}
            predict_s = time.perf_counter() - t0
        finally:
            side_runs = finish_side_runs(side)
    dry = dryrun_comparison(preds, train_measured, prefill_measured, ens_wall, ens_peak,
                            ens_args, ens_counts)
    records = {k.split(":", 1)[1]: v for k, v in side_runs.items() if k.startswith("dryrun:")}
    ok = dry.pop("ok") and all(r["rc"] == 0 and r.get("record", {}).get("status") == "ok"
                               for r in records.values())
    emit("dryrun", ok=ok, predict_s=predict_s, **dry,
         records={k: dict(rc=r["rc"], seconds=r["seconds"], record=r.get("record"),
                          stderr_tail=r["stderr_tail"]) for k, r in records.items()})
    if not ok:
        return 1
    examples = {k.split(":", 1)[1]: v for k, v in side_runs.items()
                if k.startswith("example:")}
    ok = all(r["rc"] == 0 for r in examples.values())
    emit("examples", ok=ok, runs={k: dict(argv=EXAMPLES_ARGV[k], **v)
                                  for k, v in examples.items()})
    if not ok:
        return 1
    new_phases_s = time.perf_counter() - t_new

    def path_count(key):
        return sum(snap.get(key, 0) for snap in path_launches.values())

    # 18. times at the main-path shapes
    reps, plain_reps = TIMING_REPS, PLAIN_REPS
    rows = {}
    fd8_scale = 1.0 / (2 * math.pi / n)
    fd8_ms = [timed(lambda a=a: FD8.fd8_partial(f, a), reps) for a in range(3)]
    fd8_plain = [timed(lambda a=a: P.stencil_axis_plain(f, a, FD8.FD8_COEFFS, False,
                                                         fd8_scale), plain_reps)
                 for a in range(3)]
    fd8_lib = []
    x5 = f[None, None]
    with torch.no_grad():
        for a in range(3):
            conv = circular_conv(FD8.FD8_COEFFS, False, fd8_scale, a, dev)
            fd8_lib.append(timed(lambda c=conv: c(x5), reps))
    rows["stencil_axis:fd8"] = dict(
        ms=sum(fd8_ms) / 3, plain_ms=sum(fd8_plain) / 3, library_ms=sum(fd8_lib) / 3,
        bound=bound_ms(2 * nbytes(f), P.stencil_flops(f.numel(), 4, False)),
        shape=list(f.shape), per_axis_ms=fd8_ms)

    pf_ms = [timed(lambda a=a: P.stencil_axis(stack2, a, PF.PREFILTER_TAPS, True, 1.0),
                   reps) for a in range(3)]
    pf_plain = [timed(lambda a=a: P.stencil_axis_plain(stack2, a, PF.PREFILTER_TAPS,
                                                        True, 1.0), plain_reps)
                for a in range(3)]
    pf_lib = []
    s5 = stack2[:, None]
    with torch.no_grad():
        for a in range(3):
            conv = circular_conv(PF.PREFILTER_TAPS, True, 1.0, a, dev)
            pf_lib.append(timed(lambda c=conv: c(s5), reps))
    rows["stencil_axis:prefilter"] = dict(
        ms=sum(pf_ms) / 3, plain_ms=sum(pf_plain) / 3, library_ms=sum(pf_lib) / 3,
        bound=bound_ms(2 * nbytes(stack2), P.stencil_flops(stack2.numel(), 8, True)),
        shape=list(stack2.shape), per_axis_ms=pf_ms)

    m = f.numel()
    for sfx, plan in plans.items():
        rows["apply_plan" + sfx] = dict(
            ms=timed(lambda p=plan: K.apply_plan(coef1, p), reps),
            plain_ms=timed(lambda p=plan: K.apply_plan_plain(coef1, p), plain_reps),
            library_ms=None,
            bound=bound_ms(plan_bytes(plan) + 2 * nbytes(coef1), K.gather_flops(m, 4)),
            shape=list(coef1.shape),
            k3_ms=timed(lambda p=plan: K.apply_plan(coef3, p), reps))
        for epi, epi_ops in K.EPILOGUE_OPS.items():
            rows[f"apply_plan_fused:{epi}{sfx}"] = dict(
                ms=timed(lambda e=epi, p=plan: K.apply_plan_fused(coef2, p, extra, e, 0.25),
                         reps),
                plain_ms=timed(lambda e=epi, p=plan: K.apply_plan_fused_plain(
                    coef2, p, extra, e, 0.25), plain_reps),
                library_ms=None,
                bound=bound_ms(plan_bytes(plan) + nbytes(coef2, extra) + 4 * m,
                               K.gather_flops(m, 4, 2) + m * epi_ops),
                shape=list(coef2.shape))
    # the plan build at the footpoints: its byte bound reads the queries and
    # writes the plan once, its operations are K4's weight work a query
    for sfx, wd in (("", None), (":bf16", bf16)):
        others = {}
        for basis in K4_BASES:
            ms = timed(lambda b=basis, w=wd: I.build_plan(foot, b, w), reps)
            if basis != "cubic_bspline":
                others[basis] = ms
                continue
            rows["build_plan:cubic_bspline" + sfx] = dict(
                ms=ms,
                plain_ms=timed(lambda w=wd: KP.build_plan_plain(foot, basis, w, shape,
                                                                (True, True, True)),
                               plain_reps),
                library_ms=None,
                bound=bound_ms(nbytes(foot) + plan_bytes(plans[sfx]),
                               m * K.QUERY_WEIGHT_OPS[basis]),
                shape=list(foot.shape))
        rows["build_plan:cubic_bspline" + sfx]["other_bases_ms"] = others
    # the matvec's contractions at size^3, nt = 4: the byte bound reads every
    # input plane and writes every output plane once; the body force with
    # its a term, as the matvec and the gradient launch it
    contract_gen = torch.Generator(device=dev).manual_seed(args.seed + 12)
    vt_c, grad_c, a_c = (torch.randn(dims + shape, generator=contract_gen, device=dev)
                         for dims in ((3,), (5, 3), (3,)))
    lam_c = list(torch.randn((5,) + shape, generator=contract_gen, device=dev))
    rows["traj_source"] = dict(
        ms=timed(lambda: KC.traj_sources(vt_c, grad_c), reps),
        plain_ms=timed(lambda: KC.traj_sources_plain(vt_c, grad_c), plain_reps),
        library_ms=None,
        bound=bound_ms(nbytes(vt_c, grad_c) + 5 * 4 * m, 5 * m * KC.SOURCE_OPS),
        shape=list(grad_c.shape))
    rows["traj_body_force"] = dict(
        ms=timed(lambda: KC.traj_body_force(lam_c, grad_c, 0.25, a=a_c), reps),
        plain_ms=timed(lambda: KC.traj_body_force_plain(lam_c, grad_c, 0.25, a_c),
                       plain_reps),
        library_ms=None,
        bound=bound_ms(nbytes(grad_c, a_c, *lam_c) + nbytes(a_c),
                       m * (5 * KC.BODY_OPS + KC.ADD_OPS)),
        shape=list(grad_c.shape))
    del vt_c, grad_c, a_c, lam_c
    pad = SL.DISPLACEMENT_BOUND + 1
    uniform_q = k24_query_sets(foot, args.seed, dev)["uniform"][1]
    for basis in K4_BASES:
        support = K.BASES[basis].support
        lib_call = {}
        if basis == "linear":
            # grid_sample: the same trilinear function at the same points
            for coef in (coef1, coef2):
                call = grid_sample_linear(coef, foot, pad)
                dev_lib = max_err(call().reshape(coef.shape), K.interp3d(coef, foot, basis))
                lib_call[coef.dim()] = (call, dev_lib)
        for sfx, wd in (("", None), (":bf16", bf16)):
            row = {}
            for coef in (coef1, coef2):
                kf = 1 if coef.dim() == 3 else coef.shape[0]
                lib = lib_call.get(coef.dim())
                row[kf] = dict(
                    ms=timed(lambda c=coef: K.interp3d(c, foot, basis, wd), reps),
                    ms_uniform_queries=timed(lambda c=coef: K.interp3d(c, uniform_q, basis, wd),
                                             reps),
                    plain_ms=timed(lambda c=coef: K.interp3d_plain(c, foot, basis, wd),
                                   plain_reps),
                    library_ms=timed(lib[0], reps) if lib else None,
                    library_max_abs_dev=lib[1] if lib else None,
                    bound=bound_ms(nbytes(foot) + 2 * nbytes(coef),
                                   m * K.QUERY_WEIGHT_OPS[basis]
                                   + K.gather_flops(m, support, kf)))
            rows[f"interp3d:{basis}{sfx}"] = dict(row[1], shape=list(coef1.shape),
                                                  k2=row[2])
    k5_rows = {}
    for label, x in k5_inputs.items():
        lib = valid_conv(FD8.FD8_COEFFS, k5_scale, dev)
        xb = x if x.dim() == 4 else x[None]
        with torch.no_grad():
            lib_dev = max_err(lib(xb).reshape(-1), P.stencil_valid(x, 0, FD8.FD8_COEFFS,
                                                                   k5_scale).reshape(-1))
            lib_ms = timed(lambda: lib(xb), reps)
        out_numel = x.numel() // x.shape[-3] * (x.shape[-3] - 8)
        k5_rows[label] = dict(
            ms=timed(lambda x=x: P.stencil_valid(x, 0, FD8.FD8_COEFFS, k5_scale), reps),
            plain_ms=timed(lambda x=x: P.stencil_valid_plain(x, 0, FD8.FD8_COEFFS, k5_scale),
                           plain_reps),
            library_ms=lib_ms, library_max_abs_dev=lib_dev,
            bound=bound_ms(nbytes(x) + 4 * out_numel, P.stencil_flops(out_numel, 4, False)),
            shape=list(x.shape))
    rows["stencil_valid:fd8"] = dict(k5_rows["1 rank"], stack=k5_rows["4 slabs, 5 fields"])

    # K6: shape (a) causal, the qwen1.5-0.5b prefill; the other cases beside
    k6_rows = {}
    for label, (bh, s_len, hd, dt, flags) in k6_cases.items():
        qkv = k6_inputs[label]
        peak = PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_FP32_FLOPS
        for causal in flags:
            k6_rows[f"{label} causal={causal}"] = dict(
                ms=timed(lambda qkv=qkv, c=causal: FA.flash_attention(*qkv, causal=c), reps),
                bound=bound_ms(4 * nbytes(qkv[0]), attention_flops(bh, s_len, hd, causal), peak),
                shape=[bh, s_len, hd], dtype=dt)
    qa, ka, va = k6_inputs["a"]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qa[None], ka[None], va[None], is_causal=True)[0]

    offset_rows = {}
    bh, s_kv, s_q, hd, offsets = K6_OFFSET
    for dt, (qf, kf, vf) in k6_offset_inputs.items():
        hw = dict(HW, peak_flops=PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_FP32_FLOPS)
        for off in offsets:
            q = qf[:, off:off + s_q].contiguous()
            mask = (torch.arange(s_kv, device=dev)[None, :]
                    <= off + torch.arange(s_q, device=dev)[:, None])
            flops, nb = k6_offset_cost(bh, s_kv, s_q, hd, off, qf.element_size())
            roof = kernel_roofline(flops, nb, hw=hw)
            offset_rows[f"{dt} offset={off}"] = dict(
                ms=timed(lambda q=q, kf=kf, vf=vf, o=off: FA.flash_attention(
                    q, kf, vf, causal=True, q_offset=o), reps),
                bound_ms=roof.roofline_s * 1e3,
                bound_by="operations" if roof.bound == "compute" else "bytes",
                library_ms=timed(lambda q=q, kf=kf, vf=vf, mask=mask:
                                 torch.nn.functional.scaled_dot_product_attention(
                                     q[None], kf[None], vf[None], attn_mask=mask), reps),
                flops=flops, bytes=nb, shape=dict(q=[bh, s_q, hd], kv=[bh, s_kv, hd]),
                q_offset=off, dtype=dt)
    rows["flash_attention"] = dict(
        k6_rows.pop("a causal=True"),
        plain_ms=timed(lambda: FA.flash_attention_plain(qa, ka, va, True), plain_reps),
        library_ms=timed(sdpa, reps),
        library_max_abs_dev=max_err(sdpa().float(), FA.flash_attention(qa, ka, va, True).float()),
        causal=True, others=k6_rows, offset=offset_rows)
    for key, row in rows.items():
        row["launches_on_paths"] = path_count(key)
    emit("times", size=n, reps=reps, plain_reps=plain_reps, rows=rows,
         ptxas_k2_k4=ptxas_kernels(_build.BUILD_LOG.get("interp3d", {}).get("ptxas", []),
                                   ("apply_plan_kernel", "interp3d_kernel")))

    # 19. profile: device time by kernel group, and the idle share
    for label in ("solve", "solve_planfree"):
        kw = PATHS[label][0]
        profile_solve(label, lambda kw=kw: R.register(pair.m0, pair.m1, device=dev, **kw),
                      walls[label])
    with slab_group(dev):
        profile_solve("solve_slab", lambda: R.register_sharded(pair.m0, pair.m1, device=dev,
                                                               **SLAB_KW),
                      walls["solve_slab"])
    # the server's cold round (no disk cache), against its latency above
    profile_solve("serve cold round",
                  lambda: serve(SV.ServeConfig(max_batch=2, use_fused_matvec=True,
                                               device="cuda"), rounds[:1]),
                  serve_cold_wall)
    # the qwen1.5-0.5b prefill by kernel group, and its decode loop's idle share
    model, lm_batch, g = lm_keep
    prefill_s, decode_s = lm_walls["serve_lm:qwen1.5-0.5b"]
    profile_solve("serve_lm:qwen1.5-0.5b prefill", lambda: model.prefill(lm_batch), prefill_s)
    b, p_len = lm_batch["tokens"].shape
    cache = model.make_cache(b, p_len + g)
    first = torch.zeros((b, 1), dtype=torch.long, device=dev)

    def decode_loop():
        tok = first
        for i in range(g):
            logits, _ = model.decode_step(cache, tok, p_len + i)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]

    profile_solve("serve_lm:qwen1.5-0.5b decode", decode_loop, decode_s)
    del model, cache
    for fields in moe_profiles:
        emit("profile", **fields)
    emit("profile", **train_profile)

    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        row = rows[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=path_count(kname), max_abs_err=errs[kname],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound"][0],
            bound_by=row["bound"][1], library_ms=row["library_ms"]))
    total_s = time.perf_counter() - t_script
    emit("script", total_s=total_s, new_lm_paths_s=new_lm_s,
         new_lm_paths_share=new_lm_s / total_s, train_paths_s=train_s,
         train_paths_share=train_s / total_s, ensemble_dryrun_examples_s=new_phases_s,
         ensemble_dryrun_examples_share=new_phases_s / total_s)
    print(smi_line)
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
