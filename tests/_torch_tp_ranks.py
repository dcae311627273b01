"""The rank side of ``test_torch_tp_ops.py``, ``test_torch_tp_train.py`` and
``test_torch_tp_serve.py``: one world of 4 gloo ranks (``group.run_ranks``)
per file, which runs every mesh of the file in turn. It imports no JAX: the
spawned ranks import this module by name.

A mesh of fewer ranks than the world runs as independent replicas of it:
:func:`mesh_of` lays the world out as (replica, *shape) and gives each
replica its own groups. ``main(kind, out_path)`` runs one world and saves
rank 0's records (and whatever every rank returns) with ``torch.save``.
"""

import contextlib
import dataclasses
import sys

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS
from repro_torch.distributed import group as tGR
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tp
from repro_torch.launch import mesh as ML
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TO
from repro_torch.train import steps as TS

WORLD = 4
FP32 = dict(param_dtype="float32", compute_dtype="float32")
MESHES = {"1x2": ((1, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "pod2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
MAIN_ARCHS = ("smollm-135m", "deepseek-moe-16b", "mamba2-780m", "jamba-v0.1-52b")
SIDE_ARCHS = ("whisper-large-v3", "internvl2-1b")
#: (arch, mesh): every main arch on every mesh, the side archs on (1, 2)
CASES = [(a, m) for a in MAIN_ARCHS for m in MESHES] + [(a, "1x2") for a in SIDE_ARCHS]
ALL_ARCHS = MAIN_ARCHS + SIDE_ARCHS
#: smollm with the residual stream whole on every rank of the model group
#: (``REPRO_RESIDUAL_SEQ=0``: an all-reduce after each row-parallel product)
WHOLE_CASES = [("smollm-135m", "1x2", "residual_whole"),
               ("smollm-135m", "1x4", "residual_whole")]
#: the cases of the serve world
SERVE_CASES = CASES + WHOLE_CASES
#: the train cases of each of the two train files' worlds
TRAIN_GROUPS = {"dense": ("smollm-135m",) + SIDE_ARCHS,
                "moe_ssm": ("deepseek-moe-16b", "mamba2-780m", "jamba-v0.1-52b")}
BATCH, SEQ, STEPS, SEED = 4, 64, 3, 0
#: a MoE model's batch: two rows of a 128-token group each (on four data
#: ranks, split over ``data``)
MOE_BATCH, MOE_SEQ = 2, 128
TCFG = TO.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=6)
#: serving: prompt batch, decode batch (a MoE decode on rows split four
#: ways needs a whole 128-token group a rank), cache slots, first decode
#: position (the four steps cross a block boundary on m = 2 and 4)
PREFILL_BATCH, DECODE_BATCH, MOE_DECODE_BATCH = 4, 8, 512
CACHE_SEQ, DECODE_FROM, DECODE_STEPS = 16, 6, 4
OPS_SHAPE = (2, 8, 12)


def case_id(case):
    return "-".join(case)


@contextlib.contextmanager
def residual_of(case):
    """The residual layout of ``case``: whole for a WHOLE_CASES case."""
    saved = shd.RESIDUAL_SEQ_SHARD
    shd.RESIDUAL_SEQ_SHARD = case not in WHOLE_CASES
    try:
        yield
    finally:
        shd.RESIDUAL_SEQ_SHARD = saved


_MESH_CACHE = {}


def mesh_of(mesh_name):
    """The named mesh, on this world (made once): the world laid out as
    (replica, *shape) when the mesh has fewer ranks, each replica a mesh of
    its own."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if mesh_name not in _MESH_CACHE:
        shape, axes = MESHES[mesh_name]
        n = int(np.prod(shape))
        if n == dist.get_world_size():
            mesh = ML.make_mesh(shape, axes, device="cpu")
        else:
            dm = init_device_mesh("cpu", (dist.get_world_size() // n,) + tuple(shape),
                                  mesh_dim_names=("replica",) + tuple(axes))
            mesh = ML.Mesh(shape, axes, dm)
        _MESH_CACHE[mesh_name] = mesh
    return _MESH_CACHE[mesh_name]


def model_of(arch):
    return build_model(dataclasses.replace(ARCHS[arch].smoke(), **FP32), "cpu")


def train_batches(arch):
    """The numpy batches of each step, in the model's layout."""
    model = model_of(arch)
    cfg = model.cfg
    rng = np.random.default_rng(200 + ALL_ARCHS.index(arch))
    rows, seq = (MOE_BATCH, MOE_SEQ) if cfg.n_experts else (BATCH, SEQ)
    out = []
    for _ in range(STEPS):
        b, n = {}, seq
        if cfg.is_encdec:
            b["frames"] = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
            n = model.dec_len(SEQ)
        elif cfg.family == "vlm":
            b["patches"] = rng.standard_normal((BATCH, cfg.n_patches, cfg.d_model)).astype(
                np.float32)
            n = SEQ - cfg.n_patches
        b["tokens"] = rng.integers(0, 256, (rows, n))
        b["targets"] = rng.integers(0, 256, (rows, n))
        out.append(b)
    return out


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _routes(store):
    """A spy on ``moe.route`` that keeps each call's choices and kept slots."""
    real = TM.route

    def spy(*a, **k):
        r = real(*a, **k)
        store.append((r.top_idx.clone(), r.keep.clone()))
        return r

    return real, spy


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def one_device(model, state, batch):
    """The port's one-device loss, metrics, gradients and MoE routes at
    ``state``."""
    routes = []
    real, spy = _routes(routes)
    leaves = [p.detach().requires_grad_(True) for p in TO.leaves(state.params)]
    TM.route = spy
    try:
        loss, met = model.loss(tensors(batch), TO.unflatten(state.params, leaves))
        grads = torch.autograd.grad(loss, leaves)
    finally:
        TM.route = real
    return dict(loss=loss.detach(), aux=met["aux"].detach(), grads=grads, routes=routes)


def _train_case(rank, arch, mesh_name, data):
    """STEPS sharded steps from the seeded state: the record of each step
    (the full state before and after, the gathered gradients the update
    took, the metrics, this rank's MoE routes)."""
    model = model_of(arch)
    mesh = mesh_of(mesh_name)
    full = TS.init_train_state(model, torch.Generator().manual_seed(SEED), TCFG)
    specs = TS.state_specs(model, mesh)
    p_specs = TO.leaves(specs.params)
    state = TS.shard_state(full, specs, mesh)
    seen, routes = [], []
    real_mean, real_route = shd.mean_over, TM.route
    _, route_spy = _routes(routes)

    def spy(tensors_, mesh_, axes):
        out = real_mean(tensors_, mesh_, axes)
        seen.append(out)
        return out

    step = TS.make_train_step(model, mesh, TCFG)
    n_leaves = len(TO.leaves(full.params))
    entry = shd.batch_specs(tensors(data[0]), mesh)["tokens"][0]
    block = 0   # this rank's block of the batch's rows (and of its MoE groups)
    for a in shd.entry_axes(entry):
        block = block * mesh.shape[a] + mesh.coordinate(a)
    records = []
    shd.mean_over, TM.route = spy, route_spy
    try:
        for b in data:
            routes.clear()
            state, met = step(state, tensors(b))
            grads = [shd.gather(g, s, mesh, axes=("model",))
                     for g, s in zip(seen[-1][:n_leaves], p_specs)]
            after = TS.gather_state(state, specs, mesh)
            records.append(dict(before=full, grads=grads, after=after,
                                metrics={k: v.clone() for k, v in met.items()},
                                routes=[(i.clone(), k.clone()) for i, k in routes],
                                block=block))
            full = after
    finally:
        shd.mean_over, TM.route = real_mean, real_route
    return records


def _flops(rank, data):
    """Matmul FLOPs of one smollm step on one device and on this rank of
    (1, 2) and (1, 4)."""
    model = model_of("smollm-135m")
    full = TS.init_train_state(model, torch.Generator().manual_seed(SEED), TCFG)
    out = {}
    for name in ("one", "1x2", "1x4"):
        mesh = None if name == "one" else mesh_of(name)
        specs = TS.state_specs(model, TS.resolve_mesh(mesh))
        state = full if mesh is None else TS.shard_state(full, specs, mesh)
        step = TS.make_train_step(model, mesh, TCFG)
        with FlopCounterMode(display=False) as fc:
            step(state, tensors(data[0]))
        out[name] = fc.get_total_flops()
    return out


def _leaf_moves(rank, data):
    """The shapes ``tp.gather`` gathers in one smollm step on (1, 2): the
    weights ``tp.take`` gathers, and the residual's seq blocks."""
    model = model_of("smollm-135m")
    mesh = mesh_of("1x2")
    full = TS.init_train_state(model, torch.Generator().manual_seed(SEED), TCFG)
    state = TS.shard_state(full, TS.state_specs(model, mesh), mesh)
    moved, real = [], tp.gather

    def spy(x, dim, ctx):
        moved.append((tuple(x.shape), dim))
        return real(x, dim, ctx)

    tp.gather = spy
    try:
        TS.make_train_step(model, mesh, TCFG)(state, tensors(data[0]))
    finally:
        tp.gather = real
    return moved


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _compare(rec, ref):
    """One sharded step's record against the one-device step from the same
    state: the numbers the test holds to its tolerances."""
    before, grads, after, met = rec["before"], rec["grads"], rec["after"], rec["metrics"]
    ref_p, ref_o, om = TO.adamw_update(TCFG, TO.unflatten(before.params, grads), before.opt,
                                       before.params, gnorm=met["grad_norm"])
    pairs = list(zip(TO.leaves([after.params, after.opt]), TO.leaves([ref_p, ref_o])))
    n = rec["routes"][0][0].shape[0] if rec["routes"] else 0   # the rank's groups
    at = rec["block"] * n
    return dict(
        loss=(float(met["loss"]), float(ref["loss"])), aux=(float(met["aux"]), float(ref["aux"])),
        grad_err=max(float((g - t).abs().max()) / float(t.abs().max())
                     for g, t in zip(grads, ref["grads"])),
        grad_shapes=all(g.shape == t.shape for g, t in zip(grads, ref["grads"])),
        routes=(len(rec["routes"]) == len(ref["routes"]) and all(
            torch.equal(i, j[at:at + n]) and torch.equal(k, q[at:at + n])
            for (i, k), (j, q) in zip(rec["routes"], ref["routes"]))),
        n_routes=len(rec["routes"]),
        gnorm=(float(met["grad_norm"]), float(TO.global_norm(grads))),
        update_bits=all(x.dtype == y.dtype and x.shape == y.shape and _bits(x) == _bits(y)
                        for x, y in pairs),
        lr_bits=_bits(met["lr"]) == _bits(om["lr"]))


def train_cases(group):
    return ([c for c in CASES if c[0] in TRAIN_GROUPS[group]]
            + (WHOLE_CASES if group == "dense" else []))


def train_world(rank, nprocs, data, group):
    """Every rank runs every case of the group (each holds the gathered
    records); rank k then computes the one-device step of every k-th case's
    steps and compares. Rank 0 also returns the first step's state and
    gradients of each arch's first case, for JAX. The dense group also
    counts FLOPs and the gathered leaves."""
    out = {"cmp": {}, "first": {}}
    cases = train_cases(group)
    for i, c in enumerate(cases):
        cid = case_id(c)
        with residual_of(c):
            records = _train_case(rank, c[0], c[1], data[c[0]])
        if rank == 0 and c[0] not in out["first"]:
            out["first"][c[0]] = dict(case=cid, params=records[0]["before"].params,
                                      grads=records[0]["grads"],
                                      loss=float(records[0]["metrics"]["loss"]),
                                      aux=float(records[0]["metrics"]["aux"]))
        if i % nprocs == rank:
            model = model_of(c[0])
            out["cmp"][cid] = [_compare(rec, one_device(model, rec["before"], b))
                               for rec, b in zip(records, data[c[0]])]
    if group == "dense":
        out["flops"] = _flops(rank, data["smollm-135m"])
        out["moves"] = _leaf_moves(rank, data["smollm-135m"])
    return out


# ---------------------------------------------------------------------------
# Serve: the sharded prefill and decode steps
# ---------------------------------------------------------------------------


def serve_inputs(arch):
    """(prompt batch, decode tokens, the fp32 cache's leaves as numpy in
    ``make_cache``'s tree order, and the tree's structure)."""
    model = model_of(arch)
    cfg = model.cfg
    rng = np.random.default_rng(300 + ALL_ARCHS.index(arch))
    b, n = {}, MOE_SEQ if cfg.n_experts else SEQ
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal((PREFILL_BATCH, SEQ, cfg.d_model)).astype(np.float32)
        n = model.dec_len(SEQ)
    elif cfg.family == "vlm":
        b["patches"] = rng.standard_normal((PREFILL_BATCH, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
        n = SEQ - cfg.n_patches
    b["tokens"] = rng.integers(0, 256, (PREFILL_BATCH, n))
    toks = rng.integers(0, 256, (decode_batch(model), DECODE_STEPS))
    shapes = [tuple(t.shape) for t in TO.leaves(cache_tree(model))]
    cache = [(0.5 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    return b, toks, cache


def decode_batch(model):
    return MOE_DECODE_BATCH if model.cfg.n_experts else DECODE_BATCH


def cache_tree(model, leaves=None):
    """``make_cache(decode_batch, CACHE_SEQ)`` in fp32 (every leaf), or that
    tree with ``leaves`` (numpy, in ``adamw.leaves`` order) put in."""
    cfg = model.cfg
    cross = CACHE_SEQ if cfg.is_encdec else 0
    slots = model.dec_len(CACHE_SEQ) if cfg.is_encdec else CACHE_SEQ
    tree = TT.make_stack_cache(cfg, decode_batch(model), slots, torch.device("meta"),
                               cross_seq=cross, dtype=torch.float32)
    if leaves is None:
        return tree
    return TO.unflatten(tree, [torch.from_numpy(np.array(a)) for a in leaves])


def params_of(model):
    """The seeded params tree (JAX layout) of a model, which the model then
    holds too."""
    return TS.init_train_state(model, torch.Generator().manual_seed(SEED), TCFG).params


def _serve_case(rank, arch, mesh_name, inputs, bf16_cache=False):
    model = model_of(arch)
    full = params_of(model)
    mesh = mesh_of(mesh_name)
    params = TS.shard_params(full, mesh)
    batch, toks, cache_np = inputs
    logits = TS.make_prefill_step(model, mesh)(params, tensors(batch))
    cache = cache_tree(model, cache_np)
    if bf16_cache:  # a dense model's KV leaves, as served
        cache = TO.unflatten(cache, [t.bfloat16() for t in TO.leaves(cache)])
    blocks = TS.shard_cache(cache, mesh)
    dec = TS.make_decode_step(model, mesh, decode_batch(model), CACHE_SEQ)
    steps = []
    for i in range(DECODE_STEPS):
        lg, blocks = dec(params, blocks, torch.from_numpy(toks[:, i:i + 1]), DECODE_FROM + i)
        steps.append(lg)
    gathered = TS.gather_cache(
        blocks, TS.cache_specs(model, mesh, decode_batch(model), CACHE_SEQ), mesh)
    if rank:
        return None
    return dict(prefill=logits, decode=steps, cache=TO.leaves(gathered))


def _moe_decode_refusal(inputs):
    """deepseek's decode on (2, 2) with 4 rows: 2 a rank regroup the tokens."""
    model = model_of("deepseek-moe-16b")
    try:
        TS.make_decode_step(model, mesh_of("2x2"), 4, CACHE_SEQ)
    except ValueError as e:
        return str(e)
    return None


def serve_world(rank, nprocs, inputs):
    out = {"cases": {}}
    for case in SERVE_CASES:
        with residual_of(case):
            out["cases"][case_id(case)] = _serve_case(rank, case[0], case[1],
                                                      inputs[case[0]])
    out["bf16_cache"] = _serve_case(rank, "smollm-135m", "1x4", inputs["smollm-135m"],
                                    bf16_cache=True)
    out["moe_refusal"] = _moe_decode_refusal(inputs)
    return out


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def _draw(seed, shape=OPS_SHAPE):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _ops_case(rank, mesh_name):
    """Each op's forward and gradient on this mesh, with the inputs every
    rank can rebuild: rank 0's record."""
    mesh = mesh_of(mesh_name)
    out = {}
    ctx = tp.context(mesh)
    m, r = ctx.size, ctx.rank
    x, w = _draw(1), _draw(2)
    shares = [_draw(10 + i) for i in range(m)]
    w_sh = shares[r] + (w - sum(shares) if r == 0 else 0.0)   # the shares sum to w
    parts = [_draw(20 + i) for i in range(m)]
    n = OPS_SHAPE[1] // m
    blk = slice(r * n, (r + 1) * n)

    def rec(name, y, grad):
        out[name] = dict(y=y.detach(), grad=grad)

    xb = x[:, blk].clone().requires_grad_(True)     # split -> whole
    y = tp.gather(xb, 1, ctx)
    (y * w_sh).sum().backward()
    rec("gather", y, tp.all_gather(xb.grad, 1, ctx))

    xw = x.clone().requires_grad_(True)              # whole -> split
    y = tp.split(xw, 1, ctx)
    (y * w[:, blk]).sum().backward()
    rec("split", tp.all_gather(y.detach(), 1, ctx), tp.all_reduce(xw.grad, ctx))

    xp = parts[r].clone().requires_grad_(True)       # partial -> whole
    y = tp.reduce(xp, ctx)
    (y * w_sh).sum().backward()
    rec("reduce", y, xp.grad)

    xp = parts[r].clone().requires_grad_(True)       # partial -> split
    y = tp.reduce_scatter(xp, 1, ctx)
    (y * w[:, blk]).sum().backward()
    rec("reduce_scatter", tp.all_gather(y.detach(), 1, ctx), xp.grad)

    # a Megatron pair, the vocab-parallel embed and cross entropy
    d, f, v = 12, 16, 24
    pw = {"gate": {"w": _draw(30, (d, f))}, "up": {"w": _draw(31, (d, f))},
          "down": {"w": _draw(32, (f, d))}}
    lo, hi = tp.span(ctx, f)
    blocks = {"gate": {"w": pw["gate"]["w"][:, lo:hi].clone().requires_grad_(True)},
              "up": {"w": pw["up"]["w"][:, lo:hi].clone().requires_grad_(True)},
              "down": {"w": pw["down"]["w"][lo:hi].clone().requires_grad_(True)}}
    xm = x.clone().requires_grad_(True)
    lay = tp.layout(ctx, OPS_SHAPE[1])
    y = TL.mlp(blocks, tp.from_whole(xm, lay), "silu", torch.float32, f, lay)
    (tp.to_whole(y, lay) * w_sh).sum().backward()
    out["mlp"] = dict(y=tp.to_whole(y.detach(), lay), x_grad=tp.all_reduce(xm.grad, ctx),
                      w_grads={k: tp.all_gather(blocks[k]["w"].grad, 0 if k == "down" else 1,
                                                ctx) for k in blocks})
    table = _draw(40, (v, d))
    vb = v // m
    tb = table[r * vb:(r + 1) * vb].clone().requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(41).integers(0, v - 3, OPS_SHAPE[:2]))
    e = TL.embed({"table": tb}, tokens, torch.float32, v, ctx)
    (e * w_sh).sum().backward()
    out["embed"] = dict(y=e.detach(), grad=tp.all_gather(tb.grad, 0, ctx))
    tb.grad = None
    xl = x.clone().requires_grad_(True)
    logits = TL.unembed(tb, xl, torch.float32, v, ctx)
    loss = TL.softmax_xent_tp(logits, tp.span(ctx, v)[0], tokens, v - 3, ctx)
    torch.autograd.backward(loss, torch.full_like(loss, 1.0 / m))
    out["xent"] = dict(y=loss.detach(), x_grad=tp.all_reduce(xl.grad, ctx),
                       t_grad=tp.all_gather(tb.grad, 0, ctx))
    return out if rank == 0 else None


def ops_world(rank, nprocs):
    return {name: _ops_case(rank, name) for name in ("1x2", "1x4")}


def ops_reference():
    """The unsharded functions of :func:`_ops_case`'s checks, for any m."""
    x, w = _draw(1), _draw(2)
    d, f, v = 12, 16, 24
    ref = {}
    for m in (2, 4):
        parts = [_draw(20 + i) for i in range(m)]
        ref[m] = dict(x=x, w=w, partial_sum=sum(parts))
    pw = {"gate": {"w": _draw(30, (d, f)).requires_grad_(True)},
          "up": {"w": _draw(31, (d, f)).requires_grad_(True)},
          "down": {"w": _draw(32, (f, d)).requires_grad_(True)}}
    xm = x.clone().requires_grad_(True)
    y = TL.mlp(pw, xm, "silu", torch.float32)
    (y * w).sum().backward()
    mlp = dict(y=y.detach(), x_grad=xm.grad, w_grads={k: pw[k]["w"].grad for k in pw})
    table = _draw(40, (v, d)).requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(41).integers(0, v - 3, OPS_SHAPE[:2]))
    e = TL.embed({"table": table}, tokens, torch.float32)
    (e * w).sum().backward()
    embed = dict(y=e.detach(), grad=table.grad)
    table.grad = None
    xl = x.clone().requires_grad_(True)
    loss = TL.softmax_xent(TL.unembed(table, xl, torch.float32), tokens, v - 3)
    loss.backward()
    xent = dict(y=loss.detach(), x_grad=xl.grad, t_grad=table.grad)
    return ref, dict(mlp=mlp, embed=embed, xent=xent)


def main(kind, out_path, *args):
    if kind == "ops":
        ranks = tGR.run_ranks(ops_world, WORLD, (), timeout_s=300)
        torch.save(dict(ranks=ranks), out_path)
    elif kind == "train":
        data = {arch: train_batches(arch) for arch in TRAIN_GROUPS[args[0]]}
        ranks = tGR.run_ranks(train_world, WORLD, (data, args[0]), timeout_s=500)
        torch.save(dict(data=data, ranks=ranks), out_path)
    else:
        inputs = {arch: serve_inputs(arch) for arch in ALL_ARCHS}
        ranks = tGR.run_ranks(serve_world, WORLD, (inputs,), timeout_s=500)
        torch.save(dict(inputs=inputs, ranks=ranks), out_path)


if __name__ == "__main__":
    main(*sys.argv[1:])
