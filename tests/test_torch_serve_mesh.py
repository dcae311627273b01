"""The mesh mode of the port's registration server: every wave solved by
``claire_dist.solve_ensemble_slab`` on 4 gloo ranks laid out 2 x 2
(``group.ensemble_slab_groups``), rank 0 hosting the ``Server`` and ranks
1-3 in ``serve.server.run_slab_worker``.

The stream is the 8^3 B = 2 batch of ``tests/test_torch_batch.py``
(``make_batch(1)``, amplitude 0.5, that file's fd8-linear / nt=2 /
max_newton=6 / fused matvec), in three rounds, each waited on: both pairs
cold, both again (warm starts), pair 0 alone with no subject (a padded
wave). It is held to the single-device port server on the same stream
(the JAX ensemble tests are red on JAX 0.9 and are no oracle): equal
counts, warm starts and wave shapes, ``v`` within 1e-4 * max|v|, as the
slab tests hold the slab solve to the single-device one. Every rank other
than 0 leaves its worker loop at ``stop()`` having received the three
waves. The mesh mode's errors (a layout without an ensemble group, no
padding, a wave width the ensemble does not divide, the server on a rank
other than 0, the worker on rank 0) raise.

The ranks run once for the file, in a subprocess with a timeout
(``group.run_ranks``, plain kernels on the CPU).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.data import synthetic as tS
from repro_torch.distributed import group as tGR
from repro_torch.serve import Request, ServeConfig, Server
from repro_torch.serve.server import run_slab_worker

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPE = (8, 8, 8)
VARIANT = "fd8-linear"
CFG = dict(max_batch=2, max_wait_s=0.2, nt=2, max_newton=6, use_fused_matvec=True,
           device="cpu")
V_REL = 1e-4
TIMEOUT = 300
FIELDS = ("subject", "iters", "matvecs", "converged", "warm_started", "cache_visits",
          "wave_real", "wave_padded")


def _serve(config, m0, m1):
    rounds = [[(0, "a"), (1, "b")], [(0, "a"), (1, "b")], [(0, None)]]
    out = []
    with Server(config) as srv:
        for rnd in rounds:
            futs = [srv.submit(Request(m0=m0[i], m1=m1[i], subject=s, variant=VARIANT))
                    for i, s in rnd]
            out.append([dict({f: getattr(r, f) for f in FIELDS}, v=r.v,
                             mismatch_rel=r.mismatch_rel)
                        for r in (fut.result(timeout=TIMEOUT) for fut in futs)])
        summary = srv.summary()
    return out, summary


def _errors(rank, groups):
    errors = {}
    for name, call in (
            ("plain group", lambda: ServeConfig(mesh=groups.slab, **CFG)),
            ("no padding", lambda: ServeConfig(mesh=groups, pad_waves=False, **CFG)),
            ("odd width", lambda: ServeConfig(mesh=groups, **dict(CFG, max_batch=3))),
            ("wrong role", (lambda: run_slab_worker(ServeConfig(mesh=groups, **CFG)))
             if rank == 0 else (lambda: Server(ServeConfig(mesh=groups, **CFG)).start()))):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    return errors


def _mesh_ranks(rank, nprocs, m0, m1):
    groups = tGR.ensemble_slab_groups(2, 2)
    out = {"errors": _errors(rank, groups)}
    config = ServeConfig(mesh=groups, **CFG)
    if rank == 0:
        out["served"] = _serve(config, torch.from_numpy(m0), torch.from_numpy(m1))
    else:
        out["worker_waves"] = run_slab_worker(config)
    return out


def _mesh_main(in_path, out_path):
    d = np.load(in_path)
    ranks = tGR.run_ranks(_mesh_ranks, 4, (d["m0"], d["m1"]), timeout_s=TIMEOUT - 60)
    torch.save(ranks, out_path)


@pytest.fixture(scope="module")
def batch():
    return tS.make_batch(1, SHAPE, 2, amplitude=0.5, device="cpu")


@pytest.fixture(scope="module")
def mesh(batch, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    np.savez(tmp / "in.npz", m0=batch.m0.numpy(), m1=batch.m1.numpy())
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import test_torch_serve_mesh as T; "
              f"T._mesh_main({str(tmp / 'in.npz')!r}, {str(tmp / 'out.pt')!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    return torch.load(tmp / "out.pt", weights_only=False)


@pytest.fixture(scope="module")
def single(batch):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _serve(ServeConfig(**CFG), batch.m0, batch.m1)
    finally:
        torch.set_num_threads(before)


def test_mesh_server_matches_single_device_server(mesh, single):
    got, s_got = mesh[0]["served"]
    ref, s_ref = single
    assert [len(r) for r in got] == [2, 2, 1]
    for rnd_got, rnd_ref in zip(got, ref):
        for a, b in zip(rnd_got, rnd_ref):
            assert {f: a[f] for f in FIELDS} == {f: b[f] for f in FIELDS}
            dv = float(np.max(np.abs(a["v"] - b["v"])))
            assert dv <= V_REL * float(np.max(np.abs(b["v"]))), dv
            np.testing.assert_allclose(a["mismatch_rel"], b["mismatch_rel"], rtol=1e-4)
    for k in ("submitted", "completed", "failed", "warm_hits", "waves", "utilization_mean",
              "iters_mean_warm", "iters_mean_cold"):
        assert s_got[k] == s_ref[k], k
    assert s_got["completed"] == 5 and s_got["failed"] == 0 and s_got["warm_hits"] == 2


def test_mesh_warm_round_and_partial_wave(mesh):
    # (at 8^3 and tol 5e-2 the cold solves run to the 6-step cap, so fewer
    # warm iterations is no claim here; tests/test_torch_serve.py makes it)
    got, _ = mesh[0]["served"]
    for cold, warm in zip(got[0], got[1]):
        assert not cold["warm_started"] and warm["warm_started"]
        assert warm["cache_visits"] == 1
    part = got[2][0]
    assert (part["wave_real"], part["wave_padded"]) == (1, 2)
    assert (part["iters"], part["matvecs"]) == (got[0][0]["iters"], got[0][0]["matvecs"])


def test_every_worker_leaves_its_loop(mesh):
    assert [r.get("worker_waves") for r in mesh[1:]] == [3, 3, 3]


def test_mesh_mode_errors(mesh):
    for rank, r in enumerate(mesh):
        errors = r["errors"]
        assert "no ensemble group" in errors["plain group"]
        assert "pad_waves" in errors["no padding"]
        assert "not divisible" in errors["odd width"]
        assert ("run_slab_worker" in errors["wrong role"]
                and ("hosts the Server" in errors["wrong role"])), (rank, errors)
