"""Port parity of the int8 cross-pod gradient mean
(``repro_torch.distributed.compression``): ``compressed_psum_pod`` on 4
gloo ranks against the JAX package's under ``shard_map`` on 4 forced host
devices (``conftest.run_forced``), on the same numpy input, and
``make_compressed_grad_fn`` on a (2, 2, 1) world over (pod, data, model)
against the exact mean.

Tolerances: the int8 payloads equal; the scales within one fp32 ulp
(rtol 1.2e-7: under ``jit`` XLA's CPU backend multiplies ``max|g|`` by the
fp32 reciprocal of 127, where the port divides, as JAX's ``quantize_int8``
does run op by op); the mean within 1e-6 *
max|mean| of JAX's (fp32 sums in another order), and within JAX's own bound,
2e-2 * max|exact mean| (``tests/test_distributed_multidev.py``), of the
exact mean; the grad function's loss and aux within rtol 1e-6 of the
single-process loss on the whole batch (exact means over equal shards), its
gradients within 2e-2 * max|leaf| of the exact gradients and equal on every
rank. Both sides run once for the file, each in its own subprocess with a
timeout.
"""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import compression as C
from repro_torch.distributed import group as tGR
from repro_torch.launch import mesh as ML

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = 4
TIMEOUT = 300
#: leaf -> per-rank shape; dim 0 of each input is the rank
LEAVES = {"a": (64,), "b": (3, 5, 7), "c": (33,), "zero": (4, 4)}
BOUND = 2e-2


def _inputs():
    rng = np.random.default_rng(0)
    d = {k: rng.standard_normal((P,) + s).astype(np.float32) for k, s in LEAVES.items()}
    d["b"][1, 0, 0, 0] = 40.0  # one outlier: rank 1's scale is set by it
    d["zero"][:] = 0.0         # the 1e-30 floor of the scale
    return d


JAX_BODY = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_mesh
from repro.distributed.compression import compressed_psum_pod, quantize_int8

d = dict(np.load(IN))
mesh = make_mesh((4,), ("pod",))
spec = {k: PS("pod", *([None] * (v.ndim - 1))) for k, v in d.items()}
mean = jax.jit(shard_map(lambda t: compressed_psum_pod({k: v[0] for k, v in t.items()}, "pod"),
                         mesh=mesh, in_specs=(spec,), out_specs={k: PS() for k in d},
                         check_rep=False))(d)

def quant(t):
    out = {}
    for k, v in t.items():
        q, s = quantize_int8(v[0])
        out["q_" + k], out["s_" + k] = q[None], s.reshape(1)
    return out

qs = jax.jit(shard_map(quant, mesh=mesh, in_specs=(spec,),
                       out_specs={**{"q_" + k: spec[k] for k in d},
                                  **{"s_" + k: PS("pod") for k in d}},
                       check_rep=False))(d)
np.savez(OUT, **{"mean_" + k: np.asarray(v) for k, v in mean.items()},
         **{k: np.asarray(v) for k, v in qs.items()})
"""


def _loss_fn(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2), {"aux": torch.mean(pred)}


def _grad_inputs():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((6, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    batch = {"x": rng.standard_normal((8, 6)).astype(np.float32),
             "y": rng.standard_normal((8, 3)).astype(np.float32)}
    return params, batch


def _ranks(rank, nprocs, d):
    t = {k: torch.from_numpy(d[k][rank].copy()) for k in LEAVES}
    out = {}
    for k, v in t.items():
        q, s = C.quantize_int8(v)
        out["q_" + k], out["s_" + k] = q.numpy(), s.numpy()
    mean = C.compressed_psum_pod(t, dist.group.WORLD)
    out.update({"mean_" + k: v.numpy() for k, v in mean.items()})
    # a bf16 leaf comes back bf16
    out["bf16_dtype"] = str(C.compressed_psum_pod([t["a"].bfloat16()], dist.group.WORLD)[0].dtype)
    params, batch = _grad_inputs()
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pod = ML.make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    (loss, aux), grads = C.make_compressed_grad_fn(_loss_fn, pod)(params, batch)
    out["pod"] = dict(loss=float(loss), aux=float(aux["aux"]),
                      grads={k: v.numpy() for k, v in grads.items()})
    flat = ML.make_mesh((4, 1), ("data", "model"), device="cpu")
    rows = {k: v[2 * rank:2 * rank + 2] for k, v in batch.items()}
    (loss, aux), grads = C.make_compressed_grad_fn(_loss_fn, flat)(params, rows)
    out["flat"] = dict(loss=float(loss), grads={k: v.numpy() for k, v in grads.items()})
    return out


def _port_main(in_path, out_path):
    d = dict(np.load(in_path))
    torch.save(tGR.run_ranks(_ranks, P, (d,), timeout_s=TIMEOUT - 60), out_path)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from conftest import run_forced

    tmp = tmp_path_factory.mktemp("compression")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    body = f"IN, OUT = {str(tmp / 'in.npz')!r}, {str(tmp / 'jax.npz')!r}\n" + JAX_BODY
    jax_err = []

    def jax_side():
        try:
            run_forced(P, body, timeout=TIMEOUT)
        except Exception as e:  # raised below, in the fixture's thread
            jax_err.append(e)

    thread = threading.Thread(target=jax_side)
    thread.start()
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import test_torch_compression as T; "
              f"T._port_main({str(tmp / 'in.npz')!r}, {str(tmp / 'port.pt')!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive(), "the JAX side outlived its timeout"
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    if jax_err:
        raise jax_err[0]
    return d, dict(np.load(tmp / "jax.npz")), torch.load(tmp / "port.pt", weights_only=False)


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_int8_payloads_equal_jax(sides, leaf):
    _, jx, ranks = sides
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["q_" + leaf], jx["q_" + leaf][r])
        assert out["q_" + leaf].dtype == np.int8
        np.testing.assert_allclose(out["s_" + leaf], jx["s_" + leaf][r], rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_compressed_mean_matches_jax_and_the_exact_mean(sides, leaf):
    d, jx, ranks = sides
    want, exact = jx["mean_" + leaf], d[leaf].mean(axis=0)
    scale = max(np.abs(want).max(), 1e-30)
    for out in ranks:
        got = out["mean_" + leaf]
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-6 * scale
        assert np.abs(got - exact).max() <= BOUND * max(np.abs(exact).max(), 1e-30)
        np.testing.assert_array_equal(got, ranks[0]["mean_" + leaf])
    assert all(out["bf16_dtype"] == "torch.bfloat16" for out in ranks)


def _exact(batch_rows=slice(None)):
    params, batch = _grad_inputs()
    params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    loss, aux = _loss_fn(params, {k: torch.from_numpy(v[batch_rows]) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [params["b"], params["w"]])
    return float(loss.detach()), float(aux["aux"].detach()), dict(zip(("b", "w"), grads))


def test_grad_fn_takes_the_exact_mean_in_pods_and_int8_across(sides):
    loss, aux, grads = _exact()
    ranks = sides[2]
    for out in ranks:
        got = out["pod"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(got["aux"], aux, rtol=1e-6)
        for k, g in grads.items():
            g = g.numpy()
            assert np.abs(got["grads"][k] - g).max() <= BOUND * np.abs(g).max()
            np.testing.assert_array_equal(got["grads"][k], ranks[0]["pod"]["grads"][k])


def test_grad_fn_without_a_pod_axis_is_plain_autograd(sides):
    for r, out in enumerate(sides[2]):
        loss, _, grads = _exact(slice(2 * r, 2 * r + 2))
        assert out["flat"]["loss"] == loss
        for k, g in grads.items():
            np.testing.assert_array_equal(out["flat"]["grads"][k], g.numpy())
