"""Port parity, the slab primitives: ``repro_torch.distributed.halo`` (and
``claire_dist.halo_sl_step``, ``grid.inner``/``measures._domain_mean`` with
``shard``) on 4 gloo ranks against the JAX package's halo primitives under
``shard_map`` on 4 forced host devices, on the same numpy inputs.

The field is (32, 16, 16), so each rank holds 8 rows: FD8's halo of 4 takes
the exchange's ring branch (one hop), the cubic SL halo of 6 + 7 its
all-gather branch. A 6-rank run adds the multi-hop ring (two hops), held to
a numpy periodic window. Each side runs once for the file, in its own
subprocess with a timeout: JAX through ``conftest.run_forced``, the port
through ``repro_torch.distributed.group.run_ranks`` (plain versions of the
kernels on the CPU).

Tolerances: exchanges exact (atol 0), with int8 payloads within 1e-6 of the
field's maximum; FD8 and spectral derivatives rtol 1e-5 / atol 1e-4
(``test_kernels.py``); SL steps
and characteristics 2e-5 (``test_dist_registration.py``); inner products
1e-5 relative.
"""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import grid as tG
from repro_torch.core import measures as tM
from repro_torch.distributed import claire_dist as tCD
from repro_torch.distributed import group as tGR
from repro_torch.distributed import halo as tH

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = 4
SHAPE = (32, 16, 16)
TIMEOUT = 600
METHODS = ("cubic_bspline", "linear")
#: (name, halo, compress): FD8's halo takes the ring, the SL halo the gather.
EXCHANGES = (("ring", 4, "none"), ("gather", 13, "none"),
             ("ring_int8", 4, "int8"), ("gather_int8", 13, "int8"))


def _inputs():
    rng = np.random.default_rng(0)
    f = rng.standard_normal(SHAPE).astype(np.float32)
    x = np.stack(np.meshgrid(*[np.arange(n, dtype=np.float32) for n in SHAPE],
                             indexing="ij"))
    k = 2 * np.pi * x / np.asarray(SHAPE, np.float32).reshape(3, 1, 1, 1)
    # A smooth velocity (|v| dt / h below one voxel) and footpoints that move
    # at most 3 voxels, inside the CFL contract of halo 6.
    v = 0.5 * np.stack([np.sin(k[1] + 0.3) * np.cos(k[0]), np.cos(k[2] - k[0]),
                        np.sin(k[0] + k[1] + 1.0)]).astype(np.float32)
    foot = (x + rng.uniform(-3.0, 3.0, (3,) + SHAPE)).astype(np.float32)
    return dict(f=f, g=rng.standard_normal(SHAPE).astype(np.float32),
                stack=rng.standard_normal((5,) + SHAPE).astype(np.float32),
                w=rng.standard_normal((3,) + SHAPE).astype(np.float32),
                v=v, foot=foot)


JAX_BODY = """
import numpy as np, jax
from jax.sharding import PartitionSpec as PS
from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_mesh
from repro.core import grid as G
from repro.core import measures as M
from repro.distributed import halo as H
from repro.distributed.claire_dist import halo_sl_step

d = dict(np.load(IN))
mesh = make_mesh((4,), ("slab",))
X1, X2 = PS("slab", None, None), PS(None, "slab", None, None)
X3 = PS(None, None, "slab", None, None)

def run(fn, args, in_specs, out_specs):
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                                        out_specs=out_specs, check_rep=False))(*args))

def S(halo=6, compress="none"):
    return H.ShardInfo(axis="slab", nshards=4, halo=halo, compress=compress)

out = {}
for name, halo, comp in EXCHANGES:
    out["exchange_" + name] = run(lambda f: H.exchange(f, halo, S(compress=comp)),
                                  (d["f"],), (X1,), X1)
out["exchange_stack"] = run(lambda f: H.exchange(f, 4, S()), (d["stack"],), (X2,), X2)
out["fd8_grad"] = run(lambda f: H.fd8_grad(f, S()), (d["stack"],), (X2,), X3)
out["fd8_div"] = run(lambda w: H.fd8_div(w, S()), (d["w"],), (X2,), X1)
out["spectral_grad"] = run(lambda f: H.spectral_grad(f, S()), (d["f"],), (X1,), X2)
out["spectral_div"] = run(lambda w: H.spectral_div(w, S()), (d["w"],), (X2,), X1)
for m in METHODS:
    out["coef_" + m] = run(lambda f: H.sl_coefficients(f, m, S()), (d["f"],), (X1,), X1)
    out["sl_" + m] = run(lambda f, q: H.apply_plan(H.build_plan(q, m, None, S()), f, m, S()),
                         (d["f"], d["foot"]), (X1, X2), X1)
for sign in (1.0, -1.0):
    out["trace_%+d" % sign] = run(
        lambda v: H.trace_characteristic(v, 0.25, "cubic_bspline", sign, None, S()),
        (d["v"],), (X2,), X2)
out["halo_sl_step"] = np.asarray(jax.jit(halo_sl_step(mesh, halo=8, axis="slab"))(
    d["f"], d["foot"]))
out["inner"] = run(lambda a, b: G.inner(a, b, shard=S()), (d["f"], d["g"]), (X1, X1), PS())
out["domain_mean"] = run(lambda a: M._domain_mean(a, S()), (d["f"],), (X1,), PS())
np.savez(OUT, **out)
"""


def _port_ranks(rank, nprocs, d):
    """This rank's slab of every primitive, as numpy."""
    def loc(a):
        return torch.from_numpy(interop.slab_split(a, rank, nprocs).copy())

    def S(halo=6, compress="none"):
        return tH.ShardInfo.of_group(None, halo=halo, compress=compress)

    f, stack = loc(d["f"]), loc(d["stack"])
    out = {}
    for name, halo, comp in EXCHANGES:
        out["exchange_" + name] = tH.exchange(f, halo, S(compress=comp))
    out["exchange_stack"] = tH.exchange(stack, 4, S())
    out["fd8_grad"] = tH.fd8_grad(stack, S())
    out["fd8_div"] = tH.fd8_div(loc(d["w"]), S())
    out["spectral_grad"] = tH.spectral_grad(f, S())
    out["spectral_div"] = tH.spectral_div(loc(d["w"]), S())
    for m in METHODS:
        out["coef_" + m] = tH.sl_coefficients(f, m, S())
        # one throwaway halo plan (``interp``) = build_plan + apply_plan
        out["sl_" + m] = tH.interp(f, loc(d["foot"]), m, None, S())
    for sign in (1.0, -1.0):
        out["trace_%+d" % sign] = tH.trace_characteristic(
            loc(d["v"]), 0.25, "cubic_bspline", sign, None, S())
    out["halo_sl_step"] = tCD.halo_sl_step(f, loc(d["foot"]), halo=8)
    out["inner"] = tG.inner(f, loc(d["g"]), shard=S())
    out["domain_mean"] = tM._domain_mean(f, S())
    return {k: v.numpy() for k, v in out.items()}


#: The 6-rank run: (12, 4, 4), 2 rows a rank; halo 3 takes two ring hops.
RING6 = dict(shape=(12, 4, 4), halos=((3, "none"), (3, "int8"), (1, "none")))


def _ring6_ranks(rank, nprocs, a):
    f = torch.from_numpy(interop.slab_split(a, rank, nprocs).copy())
    return {f"{h}_{c}": tH.exchange(f, h, tH.ShardInfo.of_group(None, compress=c)).numpy()
            for h, c in RING6["halos"]}


def _port_main(in_path, out_path):
    """The port's side (run in a subprocess): 4 ranks of the primitives and
    6 ranks of the two-hop ring, joined into global arrays."""
    d = dict(np.load(in_path))
    ranks = tGR.run_ranks(_port_ranks, P, (d,), timeout_s=TIMEOUT - 60)
    out = {k: (ranks[0][k] if ranks[0][k].ndim == 0 else
               interop.slab_join([r[k] for r in ranks])) for k in ranks[0]}
    out["inner_per_rank"] = np.array([r["inner"] for r in ranks])
    ring6 = tGR.run_ranks(_ring6_ranks, 6, (d["ring6"],), timeout_s=TIMEOUT - 60)
    for k in ring6[0]:
        out["ring6_" + k] = np.stack([r[k] for r in ring6])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from conftest import run_forced

    tmp = tmp_path_factory.mktemp("halo")
    d = _inputs()
    d["ring6"] = np.random.default_rng(1).standard_normal(RING6["shape"]).astype(np.float32)
    np.savez(tmp / "in.npz", **d)
    body = (f"IN, OUT = {str(tmp / 'in.npz')!r}, {str(tmp / 'jax.npz')!r}\n"
            f"EXCHANGES, METHODS = {EXCHANGES!r}, {METHODS!r}\n") + JAX_BODY
    jax_err = []

    def jax_side():
        try:
            run_forced(P, body, timeout=TIMEOUT)
        except Exception as e:  # raised below, in the fixture's thread
            jax_err.append(e)

    thread = threading.Thread(target=jax_side)
    thread.start()
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import test_torch_halo as T; "
              f"T._port_main({str(tmp / 'in.npz')!r}, {str(tmp / 'port.npz')!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive(), "the JAX side outlived its timeout"
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    if jax_err:
        raise jax_err[0]
    return d, dict(np.load(tmp / "jax.npz")), dict(np.load(tmp / "port.npz"))


@pytest.mark.parametrize("name", [e[0] for e in EXCHANGES] + ["stack"])
def test_exchange_matches_jax(sides, name):
    d, jx, pt = sides
    got, ref = pt["exchange_" + name], jx["exchange_" + name]
    assert got.shape == ref.shape
    if name.endswith("int8"):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(d["f"]).max())
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["ring", "gather"])
def test_exchange_is_the_periodic_window(sides, name):
    """Uncompressed halos are the global field's rows, exactly; int8 halos
    keep each rank's own rows exact."""
    d, _, pt = sides
    halo = dict((e[0], e[1]) for e in EXCHANGES)[name]
    n_loc = SHAPE[0] // P
    for r in range(P):
        idx = np.arange(r * n_loc - halo, (r + 1) * n_loc + halo) % SHAPE[0]
        ext = slice(r * (n_loc + 2 * halo), (r + 1) * (n_loc + 2 * halo))
        np.testing.assert_array_equal(pt["exchange_" + name][ext], d["f"][idx])
        own = pt["exchange_" + name + "_int8"][ext][halo:halo + n_loc]
        np.testing.assert_array_equal(own, d["f"][r * n_loc:(r + 1) * n_loc])


@pytest.mark.parametrize("halo,comp", RING6["halos"])
def test_two_hop_ring_is_the_periodic_window(sides, halo, comp):
    d, _, pt = sides
    a = d["ring6"]
    n_loc = a.shape[0] // 6
    got = pt[f"ring6_{halo}_{comp}"]
    for r in range(6):
        ref = a[np.arange(r * n_loc - halo, (r + 1) * n_loc + halo) % a.shape[0]]
        if comp == "int8":
            # each hop quantises what it forwards again: within half a step
            # (max|payload| / 254) per hop
            hops = -(-halo // n_loc)
            np.testing.assert_allclose(got[r], ref, rtol=0,
                                       atol=hops * np.abs(a).max() / 254 * 1.01)
            np.testing.assert_array_equal(got[r][halo:halo + n_loc], ref[halo:halo + n_loc])
        else:
            np.testing.assert_array_equal(got[r], ref)


@pytest.mark.parametrize("name", ["fd8_grad", "fd8_div", "spectral_grad", "spectral_div"])
def test_derivatives_match_jax(sides, name):
    _, jx, pt = sides
    assert pt[name].shape == jx[name].shape
    np.testing.assert_allclose(pt[name], jx[name], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", [f"{k}_{m}" for m in METHODS for k in ("coef", "sl")]
                         + ["trace_+1", "trace_-1", "halo_sl_step"])
def test_sl_primitives_match_jax(sides, name):
    _, jx, pt = sides
    assert pt[name].shape == jx[name].shape
    np.testing.assert_allclose(pt[name], jx[name], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["inner", "domain_mean"])
def test_sharded_reductions_match_jax_on_every_rank(sides, name):
    d, jx, pt = sides
    np.testing.assert_allclose(pt[name], jx[name], rtol=1e-5)
    # every rank holds the same all-reduced scalar, which is the global one
    assert len(set(pt["inner_per_rank"].tolist())) == 1
    ref = float(tG.inner(torch.from_numpy(d["f"]), torch.from_numpy(d["g"])))
    np.testing.assert_allclose(pt["inner"], ref, rtol=1e-5)
