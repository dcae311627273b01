"""Model facade: one ``nn.Module`` per architecture config with init,
loss, prefill and decode entry points.

Port of ``repro.models.api`` for every family (dense, moe, ssm, hybrid,
encdec, vlm). The JAX ``Model`` is stateless and takes its params pytree in
every call; here the params live in the module as (frozen) parameters, in
the JAX tree's layout (``embed.table``, ``final_norm.scale``,
``decoder.seg0.sub0.<layer>.mixer.wq.w``, ...; ``unembed.table`` when the
embeddings are not tied; ``encoder.seg0.sub0.<layer>...`` and
``enc_norm`` for encdec). A model is built with storage only (on the
``meta`` device, like JAX's ``abstract_params``); ``init(generator)`` draws
the weights with JAX's scales, and ``load_params(state)`` takes a state
dict; :func:`state_dict_from_tree` makes one from a tree in the JAX layout
(``interop.lm_params_from_jax``).

Training differentiates ``loss(batch, params)`` through a params tree in the
JAX layout (each segment's leaves stacked over its repeats: the train
state's, ``repro_torch.train``); the module's own parameters stay frozen.

Batch layouts (int64 tokens, bf16 float inputs), as in JAX; a train batch
adds ``targets`` of the tokens' shape (int32 or int64):
  LM family : {"tokens": (B,S)}
  encdec    : {"frames": (B,S,D), "tokens": (B,dec_len(S))}
  vlm       : {"patches": (B,P,D), "tokens": (B,S-P)}
Decode: tokens (B,1) + cache + int position. Inference runs under
``torch.inference_mode``.

``loss``, ``prefill`` and ``decode_step`` run on a model group (``ctx``,
``repro_torch.distributed.tp.context``; one rank's by default): on a mesh
with a ``model`` axis (the steps of ``repro_torch.train.steps``) they take
the rank's blocks of the params (and of the decode cache) and split their
work over the group.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn

from .. import device as _device
from ..distributed import tp
from . import layers as L
from . import transformer as T

Params = Dict[str, Any]

#: families with a port; any other raises.
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

MOE_AUX_COEFF = 0.01


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (JAX's ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def _register(module: nn.Module, tree) -> None:
    """Register a nested dict/list of tensors on ``module``: dicts become
    submodules, lists ``nn.ModuleList``s, tensors frozen parameters."""
    for name, val in tree.items():
        if isinstance(val, torch.Tensor):
            module.register_parameter(name, nn.Parameter(val, requires_grad=False))
        elif isinstance(val, list):
            lst = nn.ModuleList()
            for item in val:
                child = nn.Module()
                _register(child, item)
                lst.append(child)
            module.add_module(name, lst)
        else:
            child = nn.Module()
            _register(child, val)
            module.add_module(name, child)


def _tree(module: nn.Module):
    """The nested dict/list of tensors registered by :func:`_register`."""
    if isinstance(module, nn.ModuleList):
        return [_tree(m) for m in module]
    out = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = _tree(child)
    return out


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, torch.Tensor):
            out[key] = v
        else:
            out.update(_flatten(v, key + "."))
    return out


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _sinusoidal(seq: int, d: int, dtype, device) -> torch.Tensor:
    """(seq, d) sinusoidal positions: sin then cos, cut to d."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return pe[:, :d].to(dtype)


def _sinusoidal_at(position: int, d: int, dtype, device) -> torch.Tensor:
    """The sinusoidal encoding of one position -> (d,)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    pos = torch.tensor(float(position), dtype=torch.float32, device=device)
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return pe[:d].to(dtype)


def _unstack(seg: Mapping, n_rep: int, prefix: str) -> Dict[str, list]:
    """One segment's leaves stacked over ``n_rep`` repeats -> one tree per
    repeat (``{"sub<j>": [per-repeat tree]}``), views of the stacked leaves
    (``unbind``: one backward node per leaf, which stacks its gradient)."""
    for key, leaf in _flatten(seg, prefix).items():
        if leaf.shape[0] != n_rep:
            raise ValueError(f"{key}: {leaf.shape[0]} stacked layers, expected {n_rep}")
    out = {}
    for sub, sub_tree in seg.items():
        parts = _tree_map(lambda t: t.unbind(0), sub_tree)
        out[sub] = [_tree_map(lambda u, r=r: u[r], parts) for r in range(n_rep)]
    return out


def _stack(trees: list):
    """Trees of one structure -> one tree of their leaves stacked."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.detach() for t in trees])


def layers_from_tree(tree: Mapping, cfg, ctx=tp.ONE) -> Params:
    """The port's per-layer params tree (``Model.params()``'s layout) of a
    params tree of tensors in the JAX layout, where each decoder (and
    encoder) segment's leaves are stacked over its repeats
    (``decoder.seg0.sub0.mixer.wq.w`` of shape ``(n_rep, d_in, d_out)``);
    the layers are views of the stacked leaves, so a gradient reaches them.
    The SSM leaves ``A_log``, ``D`` and ``dt_bias`` are fp32 in any model,
    as in JAX. On a model group (``ctx``) the leaves are the rank's blocks."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported")
    if ("unembed" in tree) == bool(cfg.tie_embeddings):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the params "
                         f"{'have' if 'unembed' in tree else 'lack'} an unembed table")
    rows = tree["embed"]["table"].shape[0]
    if rows != cfg.vocab_padded and rows * ctx.size != cfg.vocab_padded:
        raise ValueError(f"embedding has {rows} rows, expected vocab_padded "
                         f"{cfg.vocab_padded} (vocab {cfg.vocab_size})")
    if ("encoder" in tree) != bool(cfg.is_encdec):
        raise ValueError(f"is_encdec={cfg.is_encdec} but the params "
                         f"{'have' if 'encoder' in tree else 'lack'} an encoder")
    out = {k: tree[k] for k in ("embed", "final_norm", "unembed", "enc_norm") if k in tree}
    out["decoder"] = {f"seg{si}": _unstack(tree["decoder"][f"seg{si}"], n_rep,
                                           f"decoder.seg{si}.")
                      for si, (n_rep, _) in enumerate(T.segments(cfg))}
    if cfg.is_encdec:
        out["encoder"] = {"seg0": _unstack(tree["encoder"]["seg0"], cfg.n_enc_layers,
                                           "encoder.seg0.")}
    return out


def state_dict_from_tree(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The state dict of ``Model(cfg)`` from a params tree in the JAX layout
    (:func:`layers_from_tree`); the model keeps one entry per layer
    (``decoder.seg0.sub0.<r>.mixer.wq.w``)."""
    return _flatten(layers_from_tree(tree, cfg))


def tree_from_layers(p: Params) -> Params:
    """The params tree in the JAX layout from the port's per-layer tree
    (``Model.params()``): each segment's layers stacked over its repeats,
    every leaf a new tensor (the inverse of :func:`layers_from_tree`)."""
    out = {k: _tree_map(lambda t: t.detach().clone(), v) for k, v in p.items()
           if k not in ("decoder", "encoder")}
    for k in ("decoder", "encoder"):
        if k in p:
            out[k] = {seg: {sub: _stack(layers) for sub, layers in subs.items()}
                      for seg, subs in p[k].items()}
    return out


class Model(nn.Module):
    def __init__(self, cfg, device="cuda"):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported; ported: {PORTED_FAMILIES}")
        self.cfg = cfg
        self.dev = _device.resolve(device)
        self.param_dtype = L.dtype_of(cfg.param_dtype)
        self.compute_dtype = L.dtype_of(cfg.compute_dtype)
        _register(self, self._make_params(None, torch.device("meta")))
        self._params = _tree(self)

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    def _make_params(self, gen: Optional[torch.Generator], device) -> Params:
        cfg, dt = self.cfg, self.param_dtype
        norm = L.make_norm if cfg.rmsnorm else L.make_layernorm
        p: Params = {
            "embed": L.make_embedding(gen, cfg.vocab_padded, cfg.d_model, dt, device),
            "final_norm": norm(cfg.d_model, dt, device),
            "decoder": T.make_stack(gen, cfg, dt, device, cross=cfg.is_encdec),
        }
        if not cfg.tie_embeddings:
            p["unembed"] = L.make_embedding(gen, cfg.vocab_padded, cfg.d_model, dt, device)
        if cfg.is_encdec:
            # the encoder: n_enc_layers non-causal (attn, dense) layers
            p["encoder"] = {"seg0": {"sub0": [
                T.make_sublayer(gen, cfg, ("attn", "dense"), dt, device)
                for _ in range(cfg.n_enc_layers)]}}
            p["enc_norm"] = norm(cfg.d_model, dt, device)
        return p

    def init(self, generator: Optional[torch.Generator] = None) -> "Model":
        """Random weights with the JAX package's scales (embeddings N(0, 0.02²),
        dense N(0, 1/d_in), biases 0, norm scales 1), drawn from
        ``generator`` (default: a CPU generator seeded 0)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        return self.load_params(_flatten(self._make_params(gen, self.dev)))

    def load_params(self, state: Mapping[str, torch.Tensor]) -> "Model":
        """Take every parameter from ``state`` (same keys, shapes and dtype
        as ``state_dict()``), moved to the model's device."""
        want = self.state_dict()
        if set(state) != set(want):
            raise ValueError(f"state keys differ: missing {sorted(set(want) - set(state))}, "
                             f"unexpected {sorted(set(state) - set(want))}")
        for k, t in want.items():
            if tuple(state[k].shape) != tuple(t.shape) or state[k].dtype != t.dtype:
                raise ValueError(f"{k}: expected {tuple(t.shape)} {t.dtype}, got "
                                 f"{tuple(state[k].shape)} {state[k].dtype}")
        self.load_state_dict({k: v.to(self.dev) for k, v in state.items()},
                             strict=True, assign=True)
        self._params = _tree(self)
        return self

    def params(self) -> Params:
        """The params as a nested dict (the JAX tree, one list entry per
        layer), built once per :meth:`load_params`."""
        return self._params

    # ------------------------------------------------------------------
    # forward pieces
    # ------------------------------------------------------------------

    def _encode(self, p: Params, frames: torch.Tensor, ctx) -> torch.Tensor:
        """The encoder states (B, S_enc, D), whole on every rank of the model
        group; the layers run on the residual layout."""
        cfg, cd = self.cfg, self.compute_dtype
        x = frames.to(device=self.dev, dtype=cd)
        x = x + _sinusoidal(x.shape[1], cfg.d_model, cd, self.dev)[None]
        lay = tp.layout(ctx, x.shape[1])
        x = tp.from_whole(x, lay)
        for layer in p["encoder"]["seg0"]["sub0"]:
            x = L.remat(lambda h, layer=layer: T.sublayer_apply(
                layer, cfg, ("attn", "dense"), h, cd, causal=False, lay=lay)[0], x)
        x = L.norm_apply(L.norm_whole(p["enc_norm"], cfg.d_model, ctx), x, cfg.norm_eps, cd)
        return tp.to_whole(x, lay)

    def _forward(self, p: Params, batch: Mapping[str, torch.Tensor], ctx):
        """The decoder stack: the inputs embedded (vocab-parallel on a model
        group), the residual in ``sharding.residual_constraint``'s layout
        between layer bodies; -> (the whole sequence before the final norm,
        the summed MoE aux losses)."""
        cfg, cd = self.cfg, self.compute_dtype
        enc = self._encode(p, batch["frames"], ctx) if cfg.is_encdec else None
        x = L.embed(p["embed"], batch["tokens"].to(self.dev), cd, cfg.vocab_padded, ctx)
        if cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(device=self.dev, dtype=cd), x], dim=1)
        if cfg.is_encdec:
            x = x + _sinusoidal(x.shape[1], cfg.d_model, cd, self.dev)[None]
        lay = tp.layout(ctx, x.shape[1])
        x, aux = T.stack_apply(p["decoder"], cfg, tp.from_whole(x, lay), cd, causal=True,
                               enc_states=enc, lay=lay)
        return tp.to_whole(x, lay), aux

    def _logits(self, p: Params, x, ctx, whole: bool = True) -> torch.Tensor:
        """The final norm and the logits of x: this rank's vocab columns
        (``L.unembed``), all-gathered over the group when ``whole``."""
        cfg = self.cfg
        x = L.norm_apply(L.norm_whole(p["final_norm"], cfg.d_model, ctx), x, cfg.norm_eps,
                         self.compute_dtype)
        table = p["embed"]["table"] if cfg.tie_embeddings else p["unembed"]["table"]
        logits = L.unembed(table, x, self.compute_dtype, cfg.vocab_padded, ctx)
        if whole and logits.shape[-1] < cfg.vocab_padded:
            logits = tp.all_gather(logits, -1, ctx)
        return logits

    # ------------------------------------------------------------------
    # public: loss / prefill / decode
    # ------------------------------------------------------------------

    def loss(self, batch: Mapping[str, torch.Tensor], params: Optional[Params] = None,
             ctx=tp.ONE):
        """(total, {"xent": ..., "aux": ...}) of a train batch: the mean fp32
        cross entropy of ``targets`` (over the text positions for vlm; the
        encoder runs first for encdec) plus ``MOE_AUX_COEFF`` x the summed
        MoE load-balance losses. ``params`` is a params tree in the JAX
        layout (the train state's), whose leaves autograd differentiates;
        by default the model's own (frozen) weights. Self-attention takes the
        blockwise path where autograd records, K6 elsewhere. On a model group
        (``ctx``) ``params`` are the rank's blocks and the loss is whole on
        every rank (vocab-parallel cross entropy where the vocabulary
        splits)."""
        cfg = self.cfg
        p = self.params() if params is None else layers_from_tree(params, cfg, ctx)
        x, aux = self._forward(p, batch, ctx)
        if cfg.family == "vlm":  # loss over the text positions only
            x = x[:, batch["patches"].shape[1]:]
        logits = self._logits(p, x, ctx, whole=False)
        targets = batch["targets"].to(self.dev)
        if logits.shape[-1] < cfg.vocab_padded:
            xent = L.softmax_xent_tp(logits, tp.span(ctx, cfg.vocab_padded)[0], targets,
                                     cfg.vocab_size, ctx)
        else:
            xent = L.softmax_xent(logits, targets, cfg.vocab_size)
        return xent + MOE_AUX_COEFF * aux, {"xent": xent, "aux": aux}

    @torch.inference_mode()
    def prefill(self, batch: Mapping[str, torch.Tensor], params: Optional[Params] = None,
                ctx=tp.ONE) -> torch.Tensor:
        """Forward over the prompt (``tokens``, with ``frames`` for encdec or
        ``patches`` for vlm); returns the last position's logits over the
        padded vocabulary, (B, 1, V_padded), whole on every rank of the
        model group. ``params``: a params tree in the JAX layout (on a model
        group, ``ctx``, the rank's blocks); by default the model's own."""
        p = self.params() if params is None else layers_from_tree(params, self.cfg, ctx)
        x, _ = self._forward(p, batch, ctx)
        return self._logits(p, x[:, -1:], ctx)

    @torch.inference_mode()
    def decode_step(self, cache: Params, tokens: torch.Tensor, position: int,
                    params: Optional[Params] = None, ctx=tp.ONE, cache_lens=None):
        """One token per request at ``position``: (logits (B,1,V_padded),
        cache), the cache updated in place. ``params`` as in :meth:`prefill`;
        on a model group the cache holds the rank's blocks
        (``sharding.cache_specs``) of a cache of ``cache_lens`` (self, cross)
        slots, and the logits are whole on every rank."""
        cfg, cd = self.cfg, self.compute_dtype
        p = self.params() if params is None else layers_from_tree(params, cfg, ctx)
        x = L.embed(p["embed"], tokens.to(self.dev), cd, cfg.vocab_padded, ctx)
        if cfg.is_encdec:
            x = x + _sinusoidal_at(position, cfg.d_model, cd, self.dev)[None, None, :]
        x, cache = T.stack_decode(p["decoder"], cfg, x, cache, int(position), cd,
                                  has_cross=cfg.is_encdec, ctx=ctx, cache_lens=cache_lens)
        return self._logits(p, x, ctx), cache

    @torch.inference_mode()
    def make_cache(self, batch: int, seq: int) -> Params:
        """Zero decode caches for ``seq`` positions: for encdec ``dec_len(seq)``
        self-attention slots and ``seq`` cross-attention slots, as in JAX."""
        return self._cache(batch, seq, self.dev)

    def _cache(self, batch: int, seq: int, device) -> Params:
        if self.cfg.is_encdec:
            return T.make_stack_cache(self.cfg, batch, self.dec_len(seq), device,
                                      cross_seq=seq)
        return T.make_stack_cache(self.cfg, batch, seq, device)

    def dec_len(self, seq: int) -> int:
        return max(seq // self.cfg.dec_ratio, 16)

    def text_len(self, seq: int) -> int:
        if self.cfg.family == "vlm":
            return seq - self.cfg.n_patches
        return seq

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def input_specs(self, shape_cfg) -> Dict:
        """Shape and dtype of every model input of one train, prefill or
        decode cell, as :class:`TensorSpec` leaves; a train batch has
        ``targets`` of the tokens' shape."""
        cfg = self.cfg
        b, s = shape_cfg.global_batch, shape_cfg.seq_len
        i64, bf16 = torch.int64, torch.bfloat16
        if shape_cfg.kind in ("train", "prefill"):
            if cfg.is_encdec:
                batch = {"frames": TensorSpec((b, s, cfg.d_model), bf16),
                         "tokens": TensorSpec((b, self.dec_len(s)), i64)}
            elif cfg.family == "vlm":
                batch = {"patches": TensorSpec((b, cfg.n_patches, cfg.d_model), bf16),
                         "tokens": TensorSpec((b, self.text_len(s)), i64)}
            else:
                batch = {"tokens": TensorSpec((b, s), i64)}
            if shape_cfg.kind == "train":
                batch["targets"] = batch["tokens"]
            return {"batch": batch}
        if shape_cfg.kind != "decode":
            raise ValueError(f"cell kind {shape_cfg.kind!r}: expected train, prefill or "
                             "decode")
        cache = _tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                          self._cache(b, s, torch.device("meta")))
        return {"cache": cache, "tokens": TensorSpec((b, 1), i64),
                "position": TensorSpec((), i64)}

    def make_batch(self, generator: torch.Generator, shape_cfg) -> Dict:
        """Random inputs matching :meth:`input_specs`, on the model's device:
        integers uniform in [0, vocab_size), floats N(0, 1), as in JAX."""

        def mk(spec):
            if isinstance(spec, dict):
                return {k: mk(v) for k, v in spec.items()}
            if isinstance(spec, list):
                return [mk(v) for v in spec]
            if spec.dtype.is_floating_point:
                x = torch.randn(spec.shape, generator=generator, device=generator.device)
                return x.to(device=self.dev, dtype=spec.dtype)
            x = torch.randint(0, self.cfg.vocab_size, spec.shape, generator=generator,
                              device=generator.device, dtype=spec.dtype)
            return x.to(self.dev)

        return mk(self.input_specs(shape_cfg))


def build_model(cfg, device="cuda") -> Model:
    return Model(cfg, device)
