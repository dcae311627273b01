"""The port's batched Newton driver (``gauss_newton.solve_batch``,
``registration.register_batch``) and its ensemble x slab mode.

* ``register_batch`` of a B = 2 batch against per-pair ``register`` at 8^3
  (fd8-linear, nt=2, fused matvec, max_newton=6): equal ``iters`` and
  ``matvecs`` and the PCG count of every step, ``v`` within 1e-6 * max|v|
  (the batched step runs each pair through the single-pair step, so they
  are bit-equal in practice); with ``donate`` on and off, with a per-pair
  ``gnorm_ref``, and warm-started from ``v0``.
* ``make_batch``'s pair 0 is ``make_pair(seed)``.
* Against JAX's vmapped ``solve_batch`` on the 8^3 B = 2 batch of
  ``repro.data.synthetic.make_batch`` (seed 1, amplitude 0.5; handed over
  as numpy), fd8-linear, nt=2, max_newton=4, the port with ``donate`` off
  and on: equal per-pair iterations, matvecs, flags and PCG counts of every
  active step, ``v`` within 1e-4 * max|v| (the tolerance of
  ``tests/test_torch_register.py``). One JAX solve for the file.
* Ensemble x slab: ``register_sharded`` of the batch on 4 gloo ranks laid
  out 2 x 2 (``group.ensemble_slab_groups``) against the port's own
  ``register_batch`` (the JAX ensemble tests are red on JAX 0.9 and are no
  oracle): equal counts, ``v`` within 1e-4 * max|v|, as the slab tests hold
  the slab solve to the single-device one; the ranks return the same
  result; a layout without an ensemble group and a batch the ensemble does
  not divide raise.

The ranks run once for the file, in a subprocess with a timeout
(``group.run_ranks``, plain kernels on the CPU).
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import gauss_newton as jGN
from repro.core import transport as jT
from repro.data import synthetic as jsyn
from repro_torch.core import gauss_newton as tGN
from repro_torch.core import registration as tR
from repro_torch.core import transport as tT
from repro_torch.data import synthetic as tS
from repro_torch.distributed import group as tGR

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPE = (8, 8, 8)
KW = dict(variant="fd8-linear", nt=2, max_newton=6, use_fused_matvec=True)
V_REL = 1e-6
SLAB_V_REL = 1e-4
TIMEOUT = 300
JAX_CFG = dict(interp="linear", deriv="fd8", nt=2)
JAX_GN = dict(max_newton=4)


@pytest.fixture(scope="module")
def batch():
    return tS.make_batch(0, SHAPE, 2, amplitude=0.5, device="cpu")


@pytest.fixture(scope="module")
def singles(batch):
    return [tR.register(batch.m0[b], batch.m1[b], device="cpu", **KW) for b in range(2)]


def _pcg(history, b=None):
    if b is None:
        return [h["pcg_iters"] for h in history]
    # a pair's entries while it was active (frozen pairs repeat their last)
    return [int(h["pcg_iters"][b]) for h in history if h["active"][b]]


def _assert_pairs_match(got, refs, rel=V_REL):
    assert got.iters == [r.iters for r in refs]
    assert got.matvecs == [r.matvecs for r in refs]
    assert got.converged == [r.converged for r in refs]
    for b, r in enumerate(refs):
        assert _pcg(got.history, b) == _pcg(r.history)
        dv = float((torch.as_tensor(got.v[b]) - r.v).abs().max())
        assert dv <= rel * float(r.v.abs().max()), (b, dv)
        np.testing.assert_allclose(got.mismatch_rel[b], r.mismatch_rel, rtol=1e-5)


def test_make_batch_pair0_is_make_pair():
    b = tS.make_batch(4, SHAPE, 3, device="cpu")
    p = tS.make_pair(4, SHAPE, device="cpu")
    for field in ("m0", "m1", "labels0", "labels1", "v_true"):
        assert torch.equal(getattr(b, field)[0], getattr(p, field))
    assert b.m0.shape == (3,) + SHAPE and b.v_true.shape == (3, 3) + SHAPE
    assert not torch.equal(b.m0[1], b.m0[0])


@pytest.mark.parametrize("donate", [False, True], ids=["host_test", "donate"])
def test_register_batch_matches_per_pair_register(batch, singles, donate):
    got = tR.register_batch(batch.m0, batch.m1, device="cpu", donate=donate, **KW)
    _assert_pairs_match(got, singles)
    assert got.m_warped.shape == (2,) + SHAPE
    assert len(got.detF) == 2 and all(d["min"] > 0 for d in got.detF)


def test_donating_step_updates_v_in_place(batch):
    v0 = torch.zeros((2, 3) + SHAPE)
    res = tGN.solve_batch(batch.m0, batch.m1, tR.make_transport_config("fd8-linear", nt=2),
                          tGN.GNConfig(max_newton=2), v0=v0, donate=True)
    assert res.v is v0 and float(v0.abs().max()) > 0
    with pytest.raises(ValueError, match="beta-continuation"):
        tGN.solve_batch(batch.m0, batch.m1, tR.make_transport_config(),
                        tGN.GNConfig(continuation=True))
    with pytest.raises(ValueError, match="batched images"):
        tGN.solve_batch(batch.m0[0], batch.m1[0], tR.make_transport_config())


@pytest.mark.parametrize("donate", [False, True], ids=["host_test", "donate"])
@pytest.mark.parametrize("case", ["gnorm_ref", "warm_start"])
def test_register_batch_references_and_warm_starts(batch, singles, case, donate):
    """Per-pair ``gnorm_ref`` (pair 1's absent: NaN falls back to the
    observed norm) and a warm start from half the cold solution, each against
    per-pair ``register`` with the same arguments."""
    if case == "gnorm_ref":
        refs_g = [1.5 * singles[0].history[0]["gnorm"], float("nan")]
        kws = [dict(gnorm_ref=refs_g[0]), {}]
        batch_kw = dict(gnorm_ref=np.array(refs_g))
    else:
        v0 = torch.stack([0.5 * s.v for s in singles])
        g0 = [s.history[0]["gnorm"] for s in singles]
        kws = [dict(v0=v0[b].clone(), gnorm_ref=g0[b]) for b in range(2)]
        batch_kw = dict(v0=v0.clone(), gnorm_ref=np.array(g0))
    refs = [tR.register(batch.m0[b], batch.m1[b], device="cpu", **KW, **kws[b])
            for b in range(2)]
    got = tR.register_batch(batch.m0, batch.m1, device="cpu", donate=donate, **KW,
                            **batch_kw)
    _assert_pairs_match(got, refs)


@pytest.fixture(scope="module")
def jax_side():
    b = jsyn.make_batch(jax.random.PRNGKey(1), SHAPE, 2, amplitude=0.5)
    m0, m1 = np.asarray(b.m0), np.asarray(b.m1)
    res = jGN.solve_batch(m0, m1, jT.TransportConfig(**JAX_CFG), jGN.GNConfig(**JAX_GN))
    return m0, m1, res


@pytest.mark.parametrize("donate", [False, True], ids=["host_test", "donate"])
def test_solve_batch_matches_jax(jax_side, donate):
    m0, m1, ref = jax_side
    got = tGN.solve_batch(torch.from_numpy(np.array(m0)), torch.from_numpy(np.array(m1)),
                          tT.TransportConfig(**JAX_CFG), tGN.GNConfig(**JAX_GN), donate=donate)
    np.testing.assert_array_equal(got.iters, np.asarray(ref.iters))
    np.testing.assert_array_equal(got.matvecs, np.asarray(ref.matvecs))
    np.testing.assert_array_equal(got.converged, np.asarray(ref.converged))
    assert len(got.history) == len(ref.history)
    v = np.asarray(ref.v)
    for b in range(2):
        assert _pcg(got.history, b) == _pcg(ref.history, b)
        dv = float(np.max(np.abs(got.v[b].numpy() - v[b])))
        assert dv <= 1e-4 * float(np.max(np.abs(v[b]))), (b, dv)
    np.testing.assert_allclose(got.rel_grad, np.asarray(ref.rel_grad), rtol=1e-3)


# ---------------------------------------------------------------------------
# Ensemble x slab on 4 gloo ranks (2 x 2)
# ---------------------------------------------------------------------------


def _summary(res):
    return dict(v=torch.as_tensor(res.v).numpy(), iters=res.iters, matvecs=res.matvecs,
                converged=res.converged, mismatch_rel=res.mismatch_rel,
                pcg=[[int(h["pcg_iters"][b]) for h in res.history if h["active"][b]]
                     for b in range(len(res.iters))],
                history_len=len(res.history))


def _ensemble_ranks(rank, nprocs, m0, m1):
    groups = tGR.ensemble_slab_groups(2, 2)
    out = {"ensemble": _summary(tR.register_sharded(m0, m1, group=groups, device="cpu",
                                                    **KW))}
    errors = {}
    for name, call in (
            ("plain group", lambda: tR.register_sharded(m0, m1, device="cpu", **KW)),
            ("odd batch", lambda: tR.register_sharded(np.concatenate([m0, m0[:1]]),
                                                      np.concatenate([m1, m1[:1]]),
                                                      group=groups, device="cpu", **KW)),
            ("multires", lambda: tR.register_sharded(m0, m1, group=groups, multires=True,
                                                     device="cpu", **KW)),
            ("layout", lambda: tGR.ensemble_slab_groups(3, 2))):
        try:
            call()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    out["sizes"] = (dist.get_world_size(groups.ensemble), dist.get_world_size(groups.slab),
                    dist.get_rank(groups.ensemble), dist.get_rank(groups.slab))
    return out


def _ensemble_main(in_path, out_path):
    d = np.load(in_path)
    ranks = tGR.run_ranks(_ensemble_ranks, 4, (d["m0"], d["m1"]), timeout_s=TIMEOUT - 60)
    torch.save(ranks, out_path)


@pytest.fixture(scope="module")
def ensemble(batch, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ensemble_slab")
    np.savez(tmp / "in.npz", m0=batch.m0.numpy(), m1=batch.m1.numpy())
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import test_torch_batch as T; "
              f"T._ensemble_main({str(tmp / 'in.npz')!r}, {str(tmp / 'out.pt')!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    return torch.load(tmp / "out.pt", weights_only=False)


def test_ensemble_slab_matches_register_batch(batch, ensemble):
    ref = tR.register_batch(batch.m0, batch.m1, device="cpu", **KW)
    for got in (r["ensemble"] for r in ensemble):
        assert got["iters"] == ref.iters and got["matvecs"] == ref.matvecs
        assert got["converged"] == ref.converged
        assert got["pcg"] == [_pcg(ref.history, b) for b in range(2)]
        assert got["history_len"] == len(ref.history)
        for b in range(2):
            dv = float(np.max(np.abs(got["v"][b] - ref.v[b].numpy())))
            assert dv <= SLAB_V_REL * float(ref.v[b].abs().max()), (b, dv)
        np.testing.assert_allclose(got["mismatch_rel"], ref.mismatch_rel, rtol=1e-4)
    first = ensemble[0]["ensemble"]
    for other in ensemble[1:]:
        np.testing.assert_array_equal(other["ensemble"]["v"], first["v"])


def test_ensemble_slab_layout_and_errors(ensemble):
    # rank r = e * S + s: ensemble rank e, slab rank s, groups of 2 each
    assert [r["sizes"] for r in ensemble] == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0),
                                              (2, 2, 1, 1)]
    for r in ensemble:
        errs = r["errors"]
        assert "no ensemble group" in errs["plain group"]
        assert "not divisible by the ensemble" in errs["odd batch"]
        assert "no multires mode" in errs["multires"]
        assert "needs 6 ranks" in errs["layout"]
