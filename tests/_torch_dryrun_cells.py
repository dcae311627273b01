"""The fake-world side of ``test_torch_dryrun.py`` and
``test_torch_tp_train.py``: dry-run cells at smoke sizes, run in a
subprocess (the ``fake`` process group must not share a process with a
gloo world), their records written as JSON. It imports no JAX.

    python tests/_torch_dryrun_cells.py <kind> <out.json>

``cells``: a one-rank smoke train step, a decode and a train cell on a
(2, 2) mesh, the (1, 4) TP cell, and the two registration modes at 16^3;
``one_rank``: the one-rank smoke train step alone;
``tp``: the TP cell alone (run again with ``REPRO_RESIDUAL_SEQ=0``);
``tp_flops``: rank 0's FLOPs of the fp32 smoke smollm step (4 x 64 tokens)
on (1, 2) and (1, 4), as ``_torch_tp_ranks._flops`` counts them on gloo
ranks.
"""

import dataclasses
import json
import sys

import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import RegistrationConfig, ShapeConfig
from repro_torch.launch import dryrun as D

torch.set_num_threads(1)

FP32 = dict(param_dtype="float32", compute_dtype="float32")
SMOKE_TRAIN = ShapeConfig("train", 32, 2, "train")
MESH_TRAIN = ShapeConfig("train", 64, 4, "train")
MESH_DECODE = ShapeConfig("decode", 64, 4, "decode")
TP_MESH = ((1, 4), ("data", "model"))
MESH_2X2 = ((2, 2), ("data", "model"))
CLAIRE = RegistrationConfig(name="claire_16", grid=(16, 16, 16), ensemble=8)


def smoke(arch, **kw):
    return dataclasses.replace(ARCHS[arch].smoke(), **kw)


def cells():
    sm = smoke("smollm-135m")
    out = dict(
        one_rank_train=D.lm_cell(sm, SMOKE_TRAIN, (1, 1), ("data", "model")),
        train_2x2=D.lm_cell(sm, MESH_TRAIN, *MESH_2X2),
        decode_2x2=D.lm_cell(sm, MESH_DECODE, *MESH_2X2),
        tp=D.lm_cell(sm, MESH_TRAIN, *TP_MESH),
        ensemble=D.claire_cell(CLAIRE, "ensemble", *MESH_2X2),
        slab=D.claire_cell(CLAIRE, "slab", *TP_MESH))
    return out


def one_rank():
    return dict(one_rank_train=D.lm_cell(smoke("smollm-135m"), SMOKE_TRAIN, (1, 1),
                                         ("data", "model")))


def tp():
    return dict(tp=D.lm_cell(smoke("smollm-135m"), MESH_TRAIN, *TP_MESH))


def tp_flops():
    cfg = smoke("smollm-135m", **FP32)
    return {f"1x{m}": D.lm_cell(cfg, MESH_TRAIN, (1, m), ("data", "model"))
            ["roofline"]["hlo_flops_device"] for m in (2, 4)}


def main(kind, out_path):
    with open(out_path, "w") as f:
        json.dump({"cells": cells, "one_rank": one_rank, "tp": tp,
                   "tp_flops": tp_flops}[kind](), f)


if __name__ == "__main__":
    main(*sys.argv[1:])
