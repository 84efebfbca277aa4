"""The language model of the port (counterpart of ``repro.models.lm``):

* ``dense``  — a pre-norm GQA transformer (llama3 and its kin);
* ``ssm``    — a Mamba-2 stack (attention-free; mamba2-2.7b);
* ``hybrid`` — a Mamba-2 stack with one *shared* transformer block applied
  before the SSM block of every ``attn_every``-th layer (Zamba2-style).

Parameters are a plain dict in the reference's layout — ``embed``,
``final_norm``, ``lm_head``, ``blocks``, whose leaves stack the layers on
a leading ``[L]`` axis, and the hybrid's ``shared_attn`` — so
:func:`repro_torch.convert.params_from_numpy` carries the reference's
parameters across leaf by leaf.  The layer loop is a Python loop over
views of the stacked leaves.

Caches follow the reference's contract (:func:`init_cache`):

* dense: ``{"kv": {"k", "v": [L, N, S, Hkv, D]}, "len"}`` with a scalar or
  per-row ``len``; rows at positions ``>= len`` are garbage until written;
* ssm: ``{"ssm": {"conv": [L, N, K-1, d_inner + 2N], "state": [L, N, H, P,
  N] float32}, "len"}``, the recurrent state of every Mamba-2 block;
* hybrid: the ssm cache plus ``"kv"`` with one ``[sites, N, S, Hkv, D]``
  slot per application of the shared attention block.

The cache-carrying functions write the new K/V and states into the cache
they are given, **in place**, and return it with the new ``len``; a
prefill of more than one token replaces the conv windows with ones in the
model's dtype, as the reference's returns them.  Only the KV families
(:data:`KV_CACHE_FAMILIES`) take the ragged prefill, the chunked catch-up
and the frontier: a recurrent state has no per-position validity to roll
back.

:data:`CALLS` counts the calls of each model function, so a run can relate
kernel launches to model calls.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .config import ModelConfig
from .layers import (
    attention_block,
    init_attention,
    init_mlp,
    mlp_block,
    normal,
    rms_norm,
    tree_attention_block,
)
from .ssm import init_ssm_block, init_ssm_cache, ssm_block

Params = Any

CALLS: dict[str, int] = {"forward": 0, "prefill": 0, "prefill_ragged": 0, "decode_chunk": 0,
                         "decode_step": 0, "decode_frontier": 0,
                         "paged_decode_step": 0, "paged_decode_frontier": 0}

# Families whose decode cache is pure position-indexed KV (the reference's
# set; the port runs the dense one).
KV_CACHE_FAMILIES = ("dense", "moe")
# Families the port runs: forward, prefill and decode.
PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def reset_calls() -> None:
    """Set every model-call count to 0."""
    for name in CALLS:
        CALLS[name] = 0


def _check_family(cfg: ModelConfig) -> None:
    """Refuse a family the port does not run yet."""
    if cfg.family in PORTED_FAMILIES:
        return
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP.md §1: MoE and the "
        "VLM/enc-dec stubs)"
    )


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (a parameter or cache tree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def layer_params(params: Params, layer: int) -> dict:
    """Views of layer ``layer``'s parameters."""
    return tree_map(lambda x: x[layer], params["blocks"])


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _init_transformer_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    def ones():
        return torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device)

    return {
        "attn_norm": ones(),
        "attn": init_attention(gen, cfg),
        "mlp_norm": ones(),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device),
        "ssm": init_ssm_block(gen, cfg, cfg.dtype),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters of the reference's shapes and dtypes (normal, std
    0.02; norms ones; an SSM block's ``A_log``/``dt_bias``/``D`` in
    float32), drawn from ``gen`` on its device, layer by layer into the
    stacked ``[L, ...]`` leaves."""
    _check_family(cfg)
    dev = gen.device
    std = 0.02
    init_layer = _init_transformer_block if cfg.family == "dense" else _init_ssm_layer

    params: dict = {
        "embed": normal(gen, (cfg.vocab_size, cfg.d_model), std, cfg.dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (cfg.d_model, cfg.vocab_size), std, cfg.dtype)
    blocks = None
    for layer in range(cfg.num_layers):
        one = init_layer(gen, cfg)
        if blocks is None:
            blocks = tree_map(lambda x: torch.empty((cfg.num_layers,) + tuple(x.shape),
                                                    dtype=x.dtype, device=dev), one)

        def put(buf, x):
            buf[layer] = x

        tree_map(put, blocks, one)
    params["blocks"] = blocks
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_transformer_block(gen, cfg)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _transformer_body(cfg, bp, x, positions, cache):
    h, new_cache = attention_block(
        bp["attn"], cfg, rms_norm(x, bp["attn_norm"], cfg.rms_eps),
        positions, cache=cache,
    )
    x = x + h
    h = mlp_block(bp["mlp"], rms_norm(x, bp["mlp_norm"], cfg.rms_eps))
    return x + h, new_cache


def _ssm_body(cfg, bp, x, cache=None, return_cache=False):
    h, new_cache = ssm_block(bp["ssm"], cfg, rms_norm(x, bp["norm"], cfg.rms_eps),
                             cache=cache, return_cache=return_cache)
    return x + h, new_cache


def _num_attn_sites(cfg: ModelConfig) -> int:
    """Applications of the hybrid's shared block (14 for zamba2-7b)."""
    if cfg.family != "hybrid" or cfg.attn_every <= 0:
        return 0
    return (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits of final hidden states ``x [..., d]``."""
    head = params.get("lm_head")
    return x @ head if head is not None else x @ params["embed"].T


# ---------------------------------------------------------------------------
# Forward (no cache)
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch) -> tuple[torch.Tensor, torch.Tensor]:
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return x, positions


def forward(params: Params, cfg: ModelConfig, batch,
            return_hidden: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward (no cache); causal attention goes through
    ``flash_attention``, the SSM scan through ``ssd_scan``.  The hybrid
    applies its shared block before the SSM block of layer ``i`` when ``i %
    attn_every == 0``.  Returns ``(logits | final hidden, aux_loss)``."""
    _check_family(cfg)
    CALLS["forward"] += 1
    x, positions = _embed_inputs(params, batch)
    for layer in range(cfg.num_layers):
        bp = layer_params(params, layer)
        if cfg.family == "dense":
            x, _ = _transformer_body(cfg, bp, x, positions, None)
            continue
        if cfg.family == "hybrid" and layer % cfg.attn_every == 0:
            # The shared transformer block (its weights the same at every site).
            x, _ = _transformer_body(cfg, params["shared_attn"], x, positions, None)
        x, _ = _ssm_body(cfg, bp, x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return unembed(params, x), aux


def logits_at(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Row ``n``'s logits at position ``positions[n]`` — one
    :func:`forward` over ``tokens [N, S]``, unembedding only the gathered
    hidden states instead of the whole ``[N, S, V]`` slab."""
    hidden, _ = forward(params, cfg, {"tokens": tokens}, return_hidden=True)
    idx = positions.to(torch.int64).reshape(-1, 1, 1).expand(-1, 1, hidden.shape[-1])
    return unembed(params, hidden.gather(1, idx))[:, 0]


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device="cuda") -> dict:
    """Zeroed decode cache of ``batch_size`` rows (module docstring): KV
    rows of ``max_len`` positions for the dense family and the hybrid's
    shared-block sites, a float32 conv window and state per SSM block;
    ``len`` 0."""
    _check_family(cfg)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim

    def kv(layers):
        shape = (layers, batch_size, max_len, hkv, hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    cache = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family == "dense":
        cache["kv"] = kv(cfg.num_layers)
        return cache
    one = init_ssm_cache(cfg, batch_size, device=device)
    cache["ssm"] = {name: x.expand((cfg.num_layers,) + tuple(x.shape)).clone()
                    for name, x in one.items()}
    if cfg.family == "hybrid":
        cache["kv"] = kv(_num_attn_sites(cfg))
    return cache


def _step_with_cache(params, cfg: ModelConfig, batch, cache,
                     last_positions=None) -> tuple[torch.Tensor, dict]:
    """Shared prefill/decode path: runs ``S`` tokens against the cache
    (written in place).  ``last_positions`` (``[B]``, prefill) gathers each
    row's final hidden state before the unembed, so the logits are
    ``[B, 1, V]``.

    A recurrent block runs its O(1) step for one token and the
    cache-producing scan for more (which starts from a zero state, as the
    reference's does); the hybrid applies its shared block with site
    ``i // attn_every``'s KV cache before the SSM block of layer ``i`` when
    ``i % attn_every == 0``."""
    _check_family(cfg)
    x, positions = _embed_inputs(params, batch)
    cur_len = torch.as_tensor(cache["len"], device=x.device)
    positions = positions + (cur_len[:, None] if cur_len.dim() == 1 else cur_len)
    s = x.shape[1]
    new_cache = dict(cache, len=cur_len + s)
    if cfg.family == "dense":
        for layer in range(cfg.num_layers):
            layer_cache = {"k": cache["kv"]["k"][layer], "v": cache["kv"]["v"][layer],
                           "len": cur_len}
            x, _ = _transformer_body(cfg, layer_params(params, layer), x, positions,
                                     layer_cache)
    else:
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        windows = []
        for layer in range(cfg.num_layers):
            if cfg.family == "hybrid" and layer % cfg.attn_every == 0:
                site = layer // cfg.attn_every
                site_cache = {"k": cache["kv"]["k"][site], "v": cache["kv"]["v"][site],
                              "len": cur_len}
                x, _ = _transformer_body(cfg, params["shared_attn"], x, positions,
                                         site_cache)
            layer_cache = None if s > 1 else {"conv": conv[layer], "state": state[layer]}
            x, nc = _ssm_body(cfg, layer_params(params, layer), x, layer_cache,
                              return_cache=True)
            state[layer] = nc["state"]
            if s > 1:
                windows.append(nc["conv"])
            else:
                conv[layer] = nc["conv"].to(conv.dtype)
        if windows:
            new_cache["ssm"] = {"conv": torch.stack(windows), "state": state}
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if s > 1 and last_positions is not None:
        idx = torch.as_tensor(last_positions, device=x.device).to(torch.int64)
        x = x.gather(1, idx.reshape(-1, 1, 1).expand(-1, 1, x.shape[-1]))
    return unembed(params, x), new_cache


def prefill(params, cfg: ModelConfig, batch, cache) -> tuple[torch.Tensor, dict]:
    """Run the prompts ``batch["tokens"] [B, S]`` through the model, filling
    the cache (every row the same length; a recurrent family's prompts
    start from a zero state).  Returns ``(logits [B, V]`` at the last
    position, ``cache)``."""
    CALLS["prefill"] += 1
    tokens = batch["tokens"]
    last = torch.full((tokens.shape[0],), tokens.shape[1] - 1, dtype=torch.int64,
                      device=tokens.device)
    logits, cache = _step_with_cache(params, cfg, batch, cache, last_positions=last)
    return logits[:, -1, :], cache


def prefill_ragged(params, cfg: ModelConfig, tokens, lengths,
                   cache) -> tuple[torch.Tensor, dict]:
    """Batched ragged prefill: ``tokens [B, S]`` right-padded, row ``b``
    valid up to ``lengths[b]``; one forward fills every cache row and the
    logits ``[B, V]`` are each row's at its own last valid position.  The
    returned cache carries the per-row ``len`` vector; positions ``>=
    len[b]`` hold garbage until a later write lands there."""
    if cfg.family not in KV_CACHE_FAMILIES:
        raise ValueError(f"prefill_ragged supports KV-cache LM families, not {cfg.family!r}")
    CALLS["prefill_ragged"] += 1
    lengths = torch.as_tensor(lengths, device=tokens.device).to(torch.int32)
    logits, cache = _step_with_cache(
        params, cfg, {"tokens": tokens}, cache,
        last_positions=torch.clamp_min(lengths - 1, 0),
    )
    return logits[:, 0], dict(cache, len=lengths)


def decode_chunk(params, cfg: ModelConfig, tokens, target,
                 cache) -> tuple[torch.Tensor, dict]:
    """Ragged chunked catch-up: ``tokens [B, C]`` are each row's next ``C``
    tokens from its own ``cache['len']``; rows below ``target`` advance to
    ``min(len + C, target)``, rows at target keep their length (their
    writes land in the garbage region).  Logits ``[B, V]`` are gathered at
    ``target - 1 - len`` (clamped into the chunk)."""
    if cfg.family not in KV_CACHE_FAMILIES:
        raise ValueError(f"decode_chunk supports KV-cache LM families, not {cfg.family!r}")
    CALLS["decode_chunk"] += 1
    cur = torch.as_tensor(cache["len"], device=tokens.device).to(torch.int32)
    target = torch.as_tensor(target, device=tokens.device).to(torch.int32)
    c = tokens.shape[1]
    gather = torch.clamp(target - 1 - cur, 0, c - 1)
    logits, cache = _step_with_cache(
        params, cfg, {"tokens": tokens}, dict(cache, len=cur), last_positions=gather
    )
    new_len = torch.where(cur < target, torch.minimum(cur + c, target), cur)
    return logits[:, 0], dict(cache, len=new_len)


def decode_step(params, cfg: ModelConfig, token, cache) -> tuple[torch.Tensor, dict]:
    """One autoregressive step.  ``token`` ``[B]`` or ``[B, 1]`` ->
    ``(logits [B, V], cache)``.  ``cache['len']`` is a scalar or a per-row
    ``[B]`` vector; each row writes and attends at its own position,
    through the ``decode_attention`` kernel on the card."""
    CALLS["decode_step"] += 1
    token = token.reshape(token.shape[0], 1)
    logits, cache = _step_with_cache(params, cfg, {"tokens": token}, cache)
    return logits[:, -1, :], cache


def decode_frontier(params, cfg: ModelConfig, tokens, cache) -> tuple[torch.Tensor, dict]:
    """Score ``A`` candidate next tokens per row in ONE forward, read-only.

    ``tokens [N, A]`` are each row's candidate children, all at absolute
    position ``cache['len']``: alternatives for the same next position, not
    a sequence.  Each layer reads the row's prefix once for all candidates
    (``tree_decode_attention`` with an identity mask over the speculative
    tail: candidate ``i`` sees the prefix and its own K/V), and the cache is
    never written.  Returns ``(logits [N, A, V], spec)`` with ``spec =
    {"k", "v": [L, N, A, Hkv, D]}``, each candidate's own K/V entry, so the
    caller can commit the chosen child's row without recomputing it.
    """
    if cfg.family not in KV_CACHE_FAMILIES:
        raise ValueError(f"decode_frontier supports KV-cache LM families, not {cfg.family!r}")
    _check_family(cfg)
    CALLS["decode_frontier"] += 1
    n, a = tokens.shape
    x = params["embed"][tokens]
    cur_len = torch.as_tensor(cache["len"], device=x.device).to(torch.int32)
    positions = (cur_len[:, None] if cur_len.dim() == 1 else cur_len).expand(n, a)
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        bp = layer_params(params, layer)
        h, k, v = tree_attention_block(
            bp["attn"], cfg, rms_norm(x, bp["attn_norm"], cfg.rms_eps), positions,
            cache["kv"]["k"][layer], cache["kv"]["v"][layer], cur_len)
        x = x + h
        x = x + mlp_block(bp["mlp"], rms_norm(x, bp["mlp_norm"], cfg.rms_eps))
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, x), {"k": torch.stack(ks), "v": torch.stack(vs)}
