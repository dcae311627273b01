"""Port parity, the slice as a whole: ``register_sharded`` on 4 gloo ranks.

* Against JAX ``register_sharded`` on 4 forced host devices, in the
  configuration of the JAX package's green
  ``test_register_sharded_matches_single_device_16cube`` (16^3,
  fd8-linear, nt=4, max_newton=5, halo 6), on the same numpy inputs: equal
  Newton iterations, |d mismatch_rel| <= 1e-4, max|dv| <= 1e-4.
* Against the port's own single-device solves on the CPU, which the other
  ``test_torch_register*`` files hold to JAX (JAX's sharded-multires test is
  red on JAX 0.9 and is no oracle): fd8-cubic with the fused matvec, bf16
  weights, a one-rank group, and sharded multires against
  ``register_multires``: equal Newton and PCG counts, max|dv| <= 1e-4.
* int8 halos: within 5e-2 of the uncompressed velocity, as
  ``tests/test_distributed_multidev.py`` holds JAX's.

Each side runs once for the file, in its own subprocess with a timeout: JAX
through ``conftest.run_forced``, the port through
``repro_torch.distributed.group.run_ranks`` (plain kernels on the CPU).
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

from repro_torch.core import registration as tR
from repro_torch.data import synthetic as tS
from repro_torch.distributed import group as tGR

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = 4
SHAPE = (16, 16, 16)
TIMEOUT = 600
LINEAR = dict(variant="fd8-linear", nt=4, max_newton=5, tol_rel_grad=5e-2)
LEVELS = [(8, 8, 8), (16, 16, 16)]
#: name -> (register_sharded keywords, single-device reference keywords)
PORT_CASES = {
    "cubic_fused": (dict(use_fused_matvec=True), dict(use_fused_matvec=True)),
    "cubic_bf16": (dict(mixed_precision=True), dict(mixed_precision=True)),
    "multires": (dict(variant="fd8-linear", nt=2, max_newton=4, levels=LEVELS, halo=4),
                 dict(variant="fd8-linear", nt=2, max_newton=4, levels=LEVELS)),
}
INT8 = dict(use_fused_matvec=True, halo_compression="int8")

JAX_BODY = """
import numpy as np
from repro.launch.mesh import make_mesh
from repro.core.registration import register_sharded

d = np.load(IN)
mesh = make_mesh((4,), ("slab",))
res = register_sharded(d["m0"], d["m1"], mesh, halo=6, **LINEAR)
np.savez(OUT, v=np.asarray(res.v), iters=res.iters, mismatch_rel=res.mismatch_rel,
         pcg=np.array([h["pcg_iters"] for h in res.history]))
"""


def _summary(res):
    return dict(v=res.v.numpy(), iters=res.iters, mismatch_rel=res.mismatch_rel,
                pcg=[h["pcg_iters"] for h in res.history], detF=res.detF,
                converged=res.converged)


def _port_ranks(rank, nprocs, m0, m1):
    """Every sharded solve on this rank; the single-device references are
    spread over the ranks, one each."""
    singles = [dist.new_group([r]) for r in range(nprocs)]
    out = {"linear": _summary(tR.register_sharded(m0, m1, halo=6, device="cpu", **LINEAR))}
    for name, (kw, _) in PORT_CASES.items():
        out[name] = _summary(tR.register_sharded(m0, m1, device="cpu", **kw))
    out["int8"] = _summary(tR.register_sharded(m0, m1, device="cpu", **INT8))
    out["p1"] = _summary(tR.register_sharded(m0, m1, group=singles[rank], device="cpu",
                                             use_fused_matvec=True))
    refs = {}
    for i, (name, (_, kw)) in enumerate(PORT_CASES.items()):
        if i % nprocs == rank:
            fn = tR.register_multires if "levels" in kw else tR.register
            refs[name] = _summary(fn(m0, m1, device="cpu", **kw))
    out["refs"] = refs
    return out


def _port_main(in_path, out_path):
    d = np.load(in_path)
    ranks = tGR.run_ranks(_port_ranks, P, (d["m0"], d["m1"]), timeout_s=TIMEOUT - 60)
    torch.save(ranks, out_path)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from conftest import run_forced

    tmp = tmp_path_factory.mktemp("register_sharded")
    pair = tS.make_pair(3, SHAPE, amplitude=0.4, device="cpu")
    np.savez(tmp / "in.npz", m0=pair.m0.numpy(), m1=pair.m1.numpy())
    body = (f"IN, OUT = {str(tmp / 'in.npz')!r}, {str(tmp / 'jax.npz')!r}\n"
            f"LINEAR = {LINEAR!r}\n") + JAX_BODY
    jax_err = []

    def jax_side():
        try:
            run_forced(P, body, timeout=TIMEOUT)
        except Exception as e:  # raised below, in the fixture's thread
            jax_err.append(e)

    thread = threading.Thread(target=jax_side)
    thread.start()
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import test_torch_register_sharded as T; "
              f"T._port_main({str(tmp / 'in.npz')!r}, {str(tmp / 'port.pt')!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive(), "the JAX side outlived its timeout"
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    if jax_err:
        raise jax_err[0]
    ranks = torch.load(tmp / "port.pt", weights_only=False)
    refs = {}
    for r in ranks:
        refs.update(r.pop("refs"))
    return dict(np.load(tmp / "jax.npz")), ranks, refs


def test_register_sharded_matches_jax_register_sharded(sides):
    jx, ranks, _ = sides
    got = ranks[0]["linear"]
    assert got["iters"] == int(jx["iters"])
    assert got["pcg"] == jx["pcg"].tolist()
    assert abs(got["mismatch_rel"] - float(jx["mismatch_rel"])) <= 1e-4
    dv = float(np.max(np.abs(got["v"] - jx["v"])))
    assert dv <= 1e-4, dv
    assert got["detF"]["min"] > 0.0


@pytest.mark.parametrize("name", sorted(PORT_CASES) + ["p1"])
def test_register_sharded_matches_single_device(sides, name):
    _, ranks, refs = sides
    # the one-rank group solves the fused fd8-cubic configuration
    got, ref = ranks[0][name], refs["cubic_fused" if name == "p1" else name]
    assert got["iters"] == ref["iters"]
    assert got["pcg"] == ref["pcg"]
    assert got["converged"] == ref["converged"]
    dv = float(np.max(np.abs(got["v"] - ref["v"])))
    assert dv <= 1e-4, dv


def test_int8_halos_stay_near_the_uncompressed_solve(sides):
    _, ranks, _ = sides
    got, ref = ranks[0]["int8"], ranks[0]["cubic_fused"]
    dv = float(np.max(np.abs(got["v"] - ref["v"])))
    assert np.isfinite(dv) and dv < 5e-2, dv
    assert got["detF"]["min"] > 0.0


@pytest.mark.parametrize("name", ["linear", "int8", "p1"] + sorted(PORT_CASES))
def test_every_rank_returns_the_gathered_result(sides, name):
    _, ranks, _ = sides
    first = ranks[0][name]
    assert first["v"].shape == (3,) + SHAPE
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[name]["v"], first["v"])
        assert other[name]["mismatch_rel"] == first["mismatch_rel"]
        assert other[name]["pcg"] == first["pcg"]
