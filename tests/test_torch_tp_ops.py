"""The tensor-parallel collectives of ``repro_torch.distributed.tp`` and the
layers built on them, against the unsharded functions.

One world of 4 gloo ranks (``tests/_torch_tp_ranks.py``, in a subprocess
with a timeout) runs a model group of m = 2 (two replicas) and of m = 4.
Each op's forward is held to the unsharded tensor and its backward to the
gradient of the unsharded function, under the port's convention (a whole
tensor's gradient is a share on each rank, the shares add up to it):

* ``gather`` (split -> whole): the whole tensor; each block's gradient;
* ``split`` (whole -> split): the blocks; the shares of the whole's gradient;
* ``reduce`` (partial -> whole): the sum; every summand's gradient is the
  sum's;
* ``reduce_scatter`` (partial -> split): the sum's blocks; the same;
* ``layers.mlp`` on a split residual (the Megatron pair), the
  vocab-parallel ``embed`` and ``unembed`` + ``softmax_xent_tp`` (a padded
  vocab tail masked by its global column): outputs and gradients of the
  input and of the weights, gathered.

The gathers and splits move data, so they are exact; the reductions add in
the collective's order (fp32 atol 1e-6), and the layers sum in another
order than one device (fp32, every element within 1e-6 * max|unsharded|).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_tp_ranks as W

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: the layers: every element within REL * max|unsharded|
REL = 1e-6
MESHES = {"1x2": 2, "1x4": 4}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ops") / "out.pt"
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import _torch_tp_ranks as W; W.main('ops', {str(out)!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    return torch.load(out, weights_only=False)["ranks"][0]


@pytest.fixture(scope="module")
def reference():
    return W.ops_reference()


def _close(got, want, **tol):
    got, want = got.detach().numpy(), want.detach().numpy()
    if tol:
        np.testing.assert_allclose(got, want, **tol)
    else:
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("op", ["gather", "split", "reduce", "reduce_scatter"])
def test_collective_forward_and_backward_match_the_unsharded_function(world, reference, op,
                                                                      mesh):
    ref = reference[0][MESHES[mesh]]
    rec = world[mesh][op]
    if op in ("reduce", "reduce_scatter"):
        _close(rec["y"], ref["partial_sum"], rtol=0, atol=1e-6)
    else:
        assert torch.equal(rec["y"], ref["x"])
    _close(rec["grad"], ref["w"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_megatron_mlp_pair_matches_mlp(world, reference, mesh):
    got, want = world[mesh]["mlp"], reference[1]["mlp"]
    _close(got["y"], want["y"])
    _close(got["x_grad"], want["x_grad"])
    for k in want["w_grads"]:
        _close(got["w_grads"][k], want["w_grads"][k])


@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_embed_is_exact(world, reference, mesh):
    got, want = world[mesh]["embed"], reference[1]["embed"]
    assert torch.equal(got["y"], want["y"])
    _close(got["grad"], want["grad"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_cross_entropy_matches_softmax_xent(world, reference, mesh):
    got, want = world[mesh]["xent"], reference[1]["xent"]
    _close(got["y"], want["y"])
    _close(got["x_grad"], want["x_grad"])
    _close(got["t_grad"], want["t_grad"])
