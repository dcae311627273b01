"""Tensor- and sequence-parallel training of the MoE, SSM and hybrid
families: the checks of ``test_torch_tp_train.py`` on the smoke configs of
deepseek-moe-16b (experts over ``model``, the shared experts a Megatron
pair), mamba2-780m (SSM heads over ``model``) and jamba-v0.1-52b (both,
with attention) on (1, 2), (1, 4) and (2, 2) over (data, model) and
(2, 2, 1) over (pod, data, model), in one world of 4 gloo ranks of their
own. A MoE batch is 2 rows of one 128-token group each, so that four data
ranks (split over ``data``) hold whole groups.
"""

import pytest
import torch

import _torch_tp_ranks as W
from test_torch_tp_train import check_case, check_jax, jax_value_and_grad, run_world

torch.set_num_threads(1)

GROUP = "moe_ssm"
CASES = W.train_cases(GROUP)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory, GROUP)


@pytest.fixture(scope="module")
def oracle():
    return jax_value_and_grad(W.TRAIN_GROUPS[GROUP])


@pytest.mark.parametrize("case", CASES, ids=W.case_id)
def test_tp_steps_match_the_one_device_step(world, case):
    check_case(world, CASES, case)


@pytest.mark.parametrize("arch", W.TRAIN_GROUPS[GROUP])
def test_tp_step_matches_jax_value_and_grad(world, oracle, arch):
    check_jax(world, oracle, arch)
