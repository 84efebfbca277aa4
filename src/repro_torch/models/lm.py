"""The language model of the port (counterpart of ``repro.models.lm``),
every family of the reference:

* ``dense``  — a pre-norm GQA transformer (llama3, phi3, deepseek, qwen2.5);
* ``moe``    — dense attention and a routed-expert MLP with fused shared
  experts (qwen2-moe, qwen3-moe);
* ``ssm``    — a Mamba-2 stack (attention-free; mamba2-2.7b);
* ``hybrid`` — a Mamba-2 stack with one *shared* transformer block applied
  before the SSM block of every ``attn_every``-th layer (Zamba2-style);
* ``vlm``    — the dense backbone with precomputed patch embeddings
  (``batch["patch_embeds"]``) prepended to the tokens (llava; the vision
  tower is stubbed);
* ``encdec`` — an encoder over precomputed frame embeddings
  (``batch["frame_embeds"]``; whisper's conv frontend is stubbed) and a
  decoder whose blocks add cross attention to the encoder's output.

Parameters are a plain dict in the reference's layout — ``embed``,
``final_norm``, ``lm_head``, ``blocks``, whose leaves stack the layers on
a leading ``[L]`` axis, the hybrid's ``shared_attn`` and the enc-dec's
``encoder.{blocks, final_norm}`` — so
:func:`repro_torch.convert.params_from_numpy` carries the reference's
parameters across leaf by leaf.  The layer loop is a Python loop over
views of the stacked leaves; with ``cfg.remat`` and grad mode on, each
layer's body runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so its activations are recomputed in the backward.

Training: :func:`loss_fn` is the reference's next-token cross entropy, the
LM head and cross entropy chunked over the sequence when
``cfg.loss_chunk > 0``; :func:`abstract_params` gives the parameters'
shapes and dtypes on the ``meta`` device without allocating them.

Caches follow the reference's contract (:func:`init_cache`):

* dense, moe, vlm: ``{"kv": {"k", "v": [L, N, S, Hkv, D]}, "len"}`` with
  a scalar or per-row ``len``; rows at positions ``>= len`` are garbage
  until written;
* encdec: the same plus ``"cross"``: ``{"k", "v": [L, N, Se, Hkv, D]}``,
  each decoder layer's cross-attention K/V of the encoder output, filled
  by :func:`prefill`;
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
back, and the vlm and encdec families need their frontend's inputs.

An MoE layer routes all tokens of a call together (its expert capacity
depends on the call's ``[B, S]``), so every function here hands it the
``[B, S]`` the reference's does.

:data:`CALLS` counts the calls of each model function, so a run can relate
kernel launches to model calls.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ssm
from .config import ModelConfig
from .layers import (
    attention_block,
    cross_attention_block,
    embed_tokens,
    init_attention,
    init_mlp,
    init_moe,
    mlp_block,
    moe_block,
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
# set): the ones the ragged prefill, the catch-up and the frontier take.
KV_CACHE_FAMILIES = ("dense", "moe")
# Families of transformer blocks (attention + MLP or MoE) at every layer.
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "encdec")

# Leaves the reference keeps in float32 whatever the model's dtype: an SSM
# block's (``ssm.FLOAT32_LEAVES``) and the MoE ``router``.
FLOAT32_LEAVES = ssm.FLOAT32_LEAVES + ("router",)


def reset_calls() -> None:
    """Set every model-call count to 0."""
    for name in CALLS:
        CALLS[name] = 0


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


def _init_transformer_block(gen: torch.Generator, cfg: ModelConfig,
                            cross: bool = False) -> dict:
    def ones():
        return torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device)

    p = {"attn_norm": ones(), "attn": init_attention(gen, cfg), "mlp_norm": ones()}
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg, cfg.dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    if cross:
        p["cross_norm"] = ones()
        p["cross"] = init_attention(gen, cfg)
    return p


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=gen.device),
        "ssm": init_ssm_block(gen, cfg, cfg.dtype),
    }


def _stacked(n: int, init_layer: Callable[[], dict], device) -> dict:
    """``n`` layers from ``init_layer``, drawn one by one into leaves
    stacked on a leading ``[n]`` axis."""
    blocks = None
    for layer in range(n):
        one = init_layer()
        if blocks is None:
            blocks = tree_map(lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                                                    device=device), one)

        def put(buf, x):
            buf[layer] = x

        tree_map(put, blocks, one)
    return blocks


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters of the reference's shapes and dtypes (normal, std
    0.02; norms ones; an SSM block's ``A_log``/``dt_bias``/``D`` and the
    MoE router in float32), drawn from ``gen`` on its device, layer by
    layer into the stacked ``[L]`` leaves."""
    dev = gen.device
    std = 0.02
    if cfg.family not in TRANSFORMER_FAMILIES + ("ssm", "hybrid"):
        raise ValueError(f"unknown model family {cfg.family!r}")
    params: dict = {
        "embed": normal(gen, (cfg.vocab_size, cfg.d_model), std, cfg.dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (cfg.d_model, cfg.vocab_size), std, cfg.dtype)
    if cfg.family in TRANSFORMER_FAMILIES:
        cross = cfg.family == "encdec"
        params["blocks"] = _stacked(cfg.num_layers,
                                    lambda: _init_transformer_block(gen, cfg, cross), dev)
    else:
        params["blocks"] = _stacked(cfg.num_layers, lambda: _init_ssm_layer(gen, cfg), dev)
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_transformer_block(gen, cfg)
    if cfg.family == "encdec":
        params["encoder"] = {
            "blocks": _stacked(cfg.num_encoder_layers,
                               lambda: _init_transformer_block(gen, cfg), dev),
            "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
        }
    return params


class _MetaSource:
    """Stands in for a generator in :func:`abstract_params`: parameters
    drawn from it are ``meta`` tensors."""

    device = torch.device("meta")


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameters' shapes and dtypes, as ``meta`` tensors (nothing is
    allocated): the counterpart of the reference's ``jax.eval_shape`` of
    ``init_params``."""
    return init_params(cfg, _MetaSource())


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _reduced(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a DTensor's partial sums reduced (its ``Partial`` mesh dims
    made ``Replicate``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if isinstance(x, DTensor) and any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(x.device_mesh, tuple(Replicate() if isinstance(p, Partial) else p
                                                for p in x.placements))
    return x


def _residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h``.  On DTensors partial sums (a row-parallel product's) are
    then reduced, so the residual stream leaves each block whole over
    ``model``, as in a Megatron block: left partial, DTensor carries the
    sums on into ever odder layouts, and on a three-axis mesh its
    redistribution planner took minutes to place one MLP."""
    return _reduced(x + h)


def _ffn(cfg, bp, x):
    """A transformer block's MLP half: ``(x + h, aux)``, ``aux`` the MoE
    router loss (``None`` for a dense MLP)."""
    xn = rms_norm(x, bp["mlp_norm"], cfg.rms_eps)
    if cfg.family == "moe":
        h, aux = moe_block(bp["moe"], cfg, xn)
        return _residual(x, h), aux
    return _residual(x, mlp_block(bp["mlp"], xn)), None


def _transformer_body(cfg, bp, x, positions, cache, enc_kv=None):
    """Self attention, cross attention to ``enc_kv`` (enc-dec), then the
    MLP or MoE.  Returns ``(x, new_cache, aux)``."""
    h, new_cache = attention_block(
        bp["attn"], cfg, rms_norm(x, bp["attn_norm"], cfg.rms_eps),
        positions, cache=cache,
    )
    x = _residual(x, h)
    if enc_kv is not None:
        x = _residual(x, cross_attention_block(bp["cross"], cfg,
                                               rms_norm(x, bp["cross_norm"], cfg.rms_eps),
                                               enc_kv))
    x, aux = _ffn(cfg, bp, x)
    return x, new_cache, aux


def _ssm_body(cfg, bp, x, cache=None, return_cache=False):
    h, new_cache = ssm_block(bp["ssm"], cfg, rms_norm(x, bp["norm"], cfg.rms_eps),
                             cache=cache, return_cache=return_cache)
    return _residual(x, h), new_cache


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


def _embed_inputs(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings, behind the patch embeddings for vlm, and their
    positions (``batch["positions"]`` or ``0..S-1``)."""
    tokens = batch["tokens"]
    # A vocab-parallel lookup's partial sums, reduced before the first block
    # as a block's output is (``_residual``).
    x = _reduced(embed_tokens(params["embed"], tokens))
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return x, positions


def _remat(cfg: ModelConfig, body: Callable) -> Callable:
    """``body``, recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant) when ``cfg.remat`` and grad mode is on."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body
    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def _run_encoder(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The enc-dec encoder over frame embeddings ``[B, Se, d]``:
    non-causal self attention (RoPE, :func:`layers.chunked_attention`) and
    the MLP per layer, then the final norm."""
    x = frames.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    enc = params["encoder"]

    def body(x, bp):
        h, _ = attention_block(bp["attn"], cfg, rms_norm(x, bp["attn_norm"], cfg.rms_eps),
                               positions, causal=False)
        x = _residual(x, h)
        return _residual(x, mlp_block(bp["mlp"], rms_norm(x, bp["mlp_norm"], cfg.rms_eps)))

    body = _remat(cfg, body)
    for layer in range(cfg.num_encoder_layers):
        x = body(x, tree_map(lambda a: a[layer], enc["blocks"]))
    return rms_norm(x, enc["final_norm"], cfg.rms_eps)


def _enc_kv(cfg: ModelConfig, bp_cross, enc_out: torch.Tensor) -> dict:
    """One decoder layer's cross-attention K/V ``[B, Se, Hkv, D]`` of the
    encoder output (no RoPE)."""
    b, se, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    k = (enc_out @ bp_cross["wk"]).reshape(b, se, hkv, hd)
    v = (enc_out @ bp_cross["wv"]).reshape(b, se, hkv, hd)
    if cfg.qkv_bias:
        k = k + bp_cross["bk"].reshape(hkv, hd)
        v = v + bp_cross["bv"].reshape(hkv, hd)
    return {"k": k, "v": v}


def forward(params: Params, cfg: ModelConfig, batch,
            return_hidden: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward (no cache); causal self attention goes through
    ``flash_attention``, the SSM scan through ``ssd_scan``.  The hybrid
    applies its shared block before the SSM block of layer ``i`` when ``i %
    attn_every == 0``; the enc-dec runs its encoder over
    ``batch["frame_embeds"]`` first.  Returns ``(logits | final hidden,
    aux)``, ``aux`` the MoE router loss summed over layers (0 for the
    other families).  With ``cfg.remat`` and grad mode on, each layer's
    body is recomputed in the backward."""
    CALLS["forward"] += 1
    x, positions = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    enc_out = (_run_encoder(params, cfg, batch["frame_embeds"]) if cfg.family == "encdec"
               else None)

    def transformer(x, bp):
        enc_kv = _enc_kv(cfg, bp["cross"], enc_out) if enc_out is not None else None
        if cfg.seq_shard_activations:
            from ..distributed.sharding import constrain

            x = constrain(x, ("pod", "data"), "model", None)
        x, _, a = _transformer_body(cfg, bp, x, positions, None, enc_kv)
        return x, a

    def recurrent(x, bp, site):
        if site:
            # The shared transformer block (its weights the same at every site).
            x, _, _ = _transformer_body(cfg, params["shared_attn"], x, positions, None)
        return _ssm_body(cfg, bp, x)[0]

    transformer, recurrent = _remat(cfg, transformer), _remat(cfg, recurrent)
    for layer in range(cfg.num_layers):
        bp = layer_params(params, layer)
        if cfg.family in TRANSFORMER_FAMILIES:
            x, a = transformer(x, bp)
            if a is not None:
                aux = aux + a
        else:
            x = recurrent(x, bp, cfg.family == "hybrid" and layer % cfg.attn_every == 0)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if return_hidden:
        return x, aux
    return unembed(params, x), aux


def _whole_last_dim(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last dim whole on every rank: a DTensor split there
    (logits over the vocab under ``model``) is gathered, since DTensor's
    rule for a ``gather`` along a split dim fails."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    last = Shard(x.dim() - 1)
    pl = tuple(Replicate() if p == last else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def _ce_terms(pred: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor):
    """(Σ nll, Σ mask) over a ``[B, S, V]`` float32 slab."""
    pred = _whole_last_dim(pred)
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, targets[..., None].to(torch.int64))[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def loss_fn(params: Params, cfg: ModelConfig, batch) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (text positions only for vlm), plus the MoE
    router loss: ``(loss + aux, {"loss", "aux", "tokens"})``, step for step
    the reference's.

    With ``cfg.loss_chunk > 0`` the LM head and cross entropy run over
    chunks of the sequence (padded to a multiple of the chunk), each chunk
    recomputed in the backward, bounding the logits to ``B × loss_chunk ×
    V`` instead of ``B × S × V``.
    """
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    mask_full = (torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=tokens.device)
                 if mask is None else mask[:, 1:])
    targets = tokens[:, 1:]
    n_patches = (batch["patch_embeds"].shape[1]
                 if cfg.family == "vlm" and "patch_embeds" in batch else 0)

    if cfg.loss_chunk <= 0:
        logits, aux = forward(params, cfg, batch)
        pred = logits[:, n_patches:][:, :-1].float()
        nll, denom = _ce_terms(pred, targets, mask_full)
        loss = nll / torch.clamp_min(denom, 1.0)
        return loss + aux, {"loss": loss, "aux": aux, "tokens": denom}

    hidden, aux = forward(params, cfg, batch, return_hidden=True)
    hidden = hidden[:, n_patches:][:, :-1]
    head = params.get("lm_head")
    head = head if head is not None else params["embed"].T
    c = cfg.loss_chunk
    pad = (-hidden.shape[1]) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask_full = F.pad(mask_full, (0, pad))

    def chunk(h_c, t_c, m_c):
        return _ce_terms((h_c @ head).float(), t_c, m_c)

    if torch.is_grad_enabled():
        chunk_fn = lambda *args: checkpoint(chunk, *args, use_reentrant=False)
    else:
        chunk_fn = chunk
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    denom = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(hidden.shape[1] // c):
        part = slice(i * c, (i + 1) * c)
        nll_c, den_c = chunk_fn(hidden[:, part], targets[:, part], mask_full[:, part])
        nll, denom = nll + nll_c, denom + den_c
    loss = nll / torch.clamp_min(denom, 1.0)
    return loss + aux, {"loss": loss, "aux": aux, "tokens": denom}


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
    rows of ``max_len`` positions for the transformer families and the
    hybrid's shared-block sites, the enc-dec's cross K/V of
    ``encoder_seq`` positions, a float32 conv window and state per SSM
    block; ``len`` 0."""
    hkv, hd = cfg.num_kv_heads, cfg.head_dim

    def kv(layers, length):
        shape = (layers, batch_size, length, hkv, hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    cache = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family in TRANSFORMER_FAMILIES:
        cache["kv"] = kv(cfg.num_layers, max_len)
        if cfg.family == "encdec":
            cache["cross"] = kv(cfg.num_layers, cfg.encoder_seq)
        return cache
    one = init_ssm_cache(cfg, batch_size, device=device)
    cache["ssm"] = {name: x.expand((cfg.num_layers,) + tuple(x.shape)).clone()
                    for name, x in one.items()}
    if cfg.family == "hybrid":
        cache["kv"] = kv(_num_attn_sites(cfg), max_len)
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
    ``i % attn_every == 0``; an enc-dec layer attends to its cached cross
    K/V."""
    x, positions = _embed_inputs(params, cfg, batch)
    cur_len = torch.as_tensor(cache["len"], device=x.device)
    positions = positions + (cur_len[:, None] if cur_len.dim() == 1 else cur_len)
    s = x.shape[1]
    new_cache = dict(cache, len=cur_len + s)
    if cfg.family in TRANSFORMER_FAMILIES:
        for layer in range(cfg.num_layers):
            layer_cache = {"k": cache["kv"]["k"][layer], "v": cache["kv"]["v"][layer],
                           "len": cur_len}
            enc_kv = ({"k": cache["cross"]["k"][layer], "v": cache["cross"]["v"][layer]}
                      if cfg.family == "encdec" else None)
            if cfg.seq_shard_activations and s > 1:
                from ..distributed.sharding import constrain

                x = constrain(x, ("pod", "data"), "model", None)
            x, _, _ = _transformer_body(cfg, layer_params(params, layer), x, positions,
                                        layer_cache, enc_kv)
    else:
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        windows = []
        for layer in range(cfg.num_layers):
            if cfg.family == "hybrid" and layer % cfg.attn_every == 0:
                site = layer // cfg.attn_every
                site_cache = {"k": cache["kv"]["k"][site], "v": cache["kv"]["v"][site],
                              "len": cur_len}
                x, _, _ = _transformer_body(cfg, params["shared_attn"], x, positions,
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
    start from a zero state; a vlm's ``patch_embeds`` go first).  An
    enc-dec runs its encoder over ``batch["frame_embeds"]`` here and
    writes each layer's cross K/V into ``cache["cross"]``.  Returns
    ``(logits [B, V]`` at the last position, ``cache)``."""
    CALLS["prefill"] += 1
    if cfg.family == "encdec":
        enc_out = _run_encoder(params, cfg, batch["frame_embeds"])
        for layer in range(cfg.num_layers):
            kv = _enc_kv(cfg, layer_params(params, layer)["cross"], enc_out)
            cache["cross"]["k"][layer] = kv["k"]
            cache["cross"]["v"][layer] = kv["v"]
    tokens = batch["tokens"]
    s = tokens.shape[1]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        s += batch["patch_embeds"].shape[1]
    last = torch.full((tokens.shape[0],), s - 1, dtype=torch.int64, device=tokens.device)
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
        x, _ = _ffn(cfg, bp, x + h)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, x), {"k": torch.stack(ks), "v": torch.stack(vs)}
