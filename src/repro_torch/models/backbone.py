"""The grouped backbone (port of `repro.models.backbone`) for every
family.

A backbone is a repeated group of sublayers (`cfg.group_pattern`),
`cfg.n_groups_stack` times, with every parameter stacked on a leading
group axis exactly as the JAX package stacks it (`groups/sub0/mixer/
in_proj` is (n_groups, d_model, d_in_proj)). The stacked leaves are what
the uplink quantizer scales (one scale per leaf) and what Algorithm 2
averages, so keeping the JAX tree keeps the uploads identical; the loop
indexes group i of each stacked leaf.

  dense   ("attn",), or a local:global pattern of sliding-window and
          full attention
  moe     ("attn",) with the routed feed-forward (`nn.moe`)
  ssm     ("ssm",)
  hybrid  ("ssm",) * attn_every + ("shared_attn",): one attention + MLP
          block, `params["shared"]`, called once a group (its group
          subtree is empty, as in JAX), its gradient the sum over the
          calls; each call keeps its own decode cache
  encdec  ("attn", "cross"): the decoder, each layer self-attention with
          its feed-forward, then cross-attention to the encoder's states
          (whisper); the bidirectional encoder is a separate stack
          (`encoder_init`, `encoder_apply`) with its layers stacked on a
          leading axis
  vlm     ("attn",) * cross_attn_every + ("cross",): gated
          cross-attention to image embeddings (llama-3.2-vision)

Modes: "train" (the full sequence), "prefill" (the full sequence, and
the decode caches it leaves), "decode" (tokens at any positions against
caches, updated in place). Serving (prefill, decode) routes every MoE
token (dropless). A cross sublayer's cache is the projected k/v of the
encoder or image states ({"k", "v"} (b, t, kv, hd)): prefill returns
it, decode attends through it and leaves it as it is. `tp_axis` runs
every dense feed-forward Megatron-style on a model group's rank, in
every mode; attention, norms, MoE experts and the Mamba-2 mixers
replicate, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
from repro_torch.tree import tree_index, tree_leaves, tree_stack


_ATTN = ("attn", "attn_local", "attn_global", "shared_attn")


def _sublayer_init(generator: torch.Generator, cfg: ArchConfig, kind: str):
    if kind == "shared_attn":
        return {}    # its parameters live in params["shared"]
    if kind in _ATTN:
        return blocks.attn_layer_init(generator, cfg)
    if kind == "cross":
        return blocks.cross_layer_init(generator, cfg,
                                       gated=cfg.family == "vlm")
    return blocks.ssm_layer_init(generator, cfg)


def backbone_init(generator: torch.Generator, cfg: ArchConfig):
    pattern = cfg.group_pattern

    def one_group():
        return {f"sub{i}": _sublayer_init(generator, cfg, kind)
                for i, kind in enumerate(pattern)}

    groups = tree_stack([one_group() for _ in range(cfg.n_groups_stack)])
    params = {"groups": groups,
              "final_norm": blocks._norm_init(cfg, cfg.d_model,
                                              device=generator.device)}
    if "shared_attn" in pattern:
        params["shared"] = blocks.attn_layer_init(generator, cfg)
    return params


def encoder_init(generator: torch.Generator, cfg: ArchConfig):
    """The bidirectional encoder stack (whisper): cfg.n_enc_layers
    self-attention + feed-forward layers stacked on a leading axis, and
    a final norm. It takes precomputed frame embeddings (the conv and
    mel frontend is a stub)."""
    enc_cfg = dataclasses.replace(cfg, moe=None)
    layers = tree_stack([blocks.attn_layer_init(generator, enc_cfg,
                                                causal=False)
                         for _ in range(cfg.n_enc_layers)])
    return {"layers": layers,
            "final_norm": blocks._norm_init(cfg, cfg.d_model,
                                            device=generator.device)}


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def _attn_cache(cfg: ArchConfig, batch: int, length: int, dtype, device):
    shape = (batch, length, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch, length), dtype=torch.int32,
                               device=device),
            "valid": torch.zeros((batch, length), dtype=torch.bool,
                                 device=device)}


def _ssm_cache(cfg: ArchConfig, batch: int, dtype, device):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {"ssm": torch.zeros((batch, n_heads, s.d_state, s.head_dim),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


def _cross_cache(cfg: ArchConfig, batch: int, dtype, device):
    t = cfg.enc_seq if cfg.family == "encdec" else cfg.n_image_tokens
    shape = (batch, t, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def sublayer_cache_shape(cfg: ArchConfig, kind: str, batch: int,
                         cache_len: int, dtype, device=None):
    """Zeroed decode cache of one sublayer (the JAX package's tree and
    leaf names): attention, the shared block's calls included, {"k",
    "v", "pos", "valid"} of cache_len slots (at most the window's),
    Mamba-2 {"ssm" (always float32), "conv"}, cross-attention {"k", "v"}
    of the encoder's enc_seq frames or the n_image_tokens."""
    if kind in _ATTN:
        window = cfg.sublayer_window(kind)
        length = cache_len if window is None else min(window, cache_len)
        return _attn_cache(cfg, batch, length, dtype, device)
    if kind == "ssm":
        return _ssm_cache(cfg, batch, dtype, device)
    if kind == "cross":
        return _cross_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_decode_caches(cfg: ArchConfig, batch: int, cache_len: int,
                       dtype=torch.bfloat16, device=None):
    """Zeroed decode caches {"subI": leaves with a leading group axis}."""
    g = cfg.n_groups_stack
    return {f"sub{i}": {name: leaf.expand((g,) + leaf.shape).clone()
                        for name, leaf in sublayer_cache_shape(
                            cfg, kind, batch, cache_len, dtype,
                            device).items()}
            for i, kind in enumerate(cfg.group_pattern)}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _kv_to_cache(kv, positions, window, cache_len: int):
    """Full-sequence k/v (b, s, kv, hd) as a decode cache. Full
    attention: the s entries at slots [0, s) of cache_len. A sliding
    window: the last `window` entries at their ring slots (pos % window),
    so that a later insert at pos % window stays consistent."""
    k, v = kv["k"], kv["v"]
    b, s = k.shape[0], k.shape[1]
    if positions is None:
        positions = torch.arange(s, device=k.device).expand(b, s)
    if window is None or window >= cache_len:
        pad = cache_len - s
        if pad < 0:
            raise ValueError(f"prefill length {s} exceeds cache {cache_len}")
        valid = torch.zeros((b, cache_len), dtype=torch.bool,
                            device=k.device)
        valid[:, :s] = True
        return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
                "pos": F.pad(positions, (0, pad)).to(torch.int32),
                "valid": valid}
    # ring: slot j holds the latest position p <= s-1 with p % window == j
    j = np.arange(window)
    src = np.clip(j + window * ((s - 1 - j) // window), 0, s - 1)
    filled = torch.from_numpy(src >= max(0, s - window)).to(k.device)
    take = torch.from_numpy(src).to(k.device)
    return {"k": k[:, take], "v": v[:, take],
            "pos": positions[:, take].to(torch.int32),
            "valid": filled.expand(b, window).clone()}


def _run_sublayer(params_i, cfg: ArchConfig, kind: str, h, *, inv_freq,
                  positions, cache, cache_index, enc_h, shared_params,
                  mode: str, cache_len: int, ssd_scan_impl,
                  cache_write_mask, paged_table, tp_axis):
    """One sublayer. Returns (h, aux, cache or None); decode updates the
    cache in place."""
    if kind in _ATTN:
        p = shared_params if kind == "shared_attn" else params_i
        window = cfg.sublayer_window(kind)
        dropless = mode != "train"      # serving never capacity-drops
        if mode == "decode":
            # only full-attention sublayers page (a sliding window is a
            # bounded per-slot ring already)
            return blocks.attn_layer_apply(
                p, cfg, h, window=window, inv_freq=inv_freq,
                positions=positions, cache=cache, cache_index=cache_index,
                cache_write_mask=cache_write_mask,
                paged_table=paged_table if window is None else None,
                moe_dropless=dropless, tp_axis=tp_axis)
        h, aux, kv = blocks.attn_layer_apply(
            p, cfg, h, window=window, inv_freq=inv_freq,
            positions=positions, return_kv=mode == "prefill",
            moe_dropless=dropless, tp_axis=tp_axis)
        return h, aux, (None if kv is None else
                        _kv_to_cache(kv, positions, window, cache_len))
    if kind == "cross":
        gated = cfg.family == "vlm"
        if mode == "decode":
            # the cross cache holds the projected states; it stays as is
            h, aux, _ = blocks.cross_layer_apply(
                params_i, cfg, h, enc_kv=cache, gated=gated,
                tp_axis=tp_axis)
            return h, aux, cache
        if enc_h is None:
            raise ValueError(f"{cfg.name}: a cross sublayer needs encoder "
                             f"or image states (enc_h)")
        h, aux, kv = blocks.cross_layer_apply(
            params_i, cfg, h, enc_h=enc_h, gated=gated, tp_axis=tp_axis)
        return h, aux, (kv if mode == "prefill" else None)
    if mode == "decode":
        h, aux, new = blocks.ssm_layer_apply(params_i, cfg, h, state=cache,
                                             token_mask=cache_write_mask)
        for name in cache:
            cache[name].copy_(new[name])
        return h, aux, cache
    return blocks.ssm_layer_apply(params_i, cfg, h, scan_impl=ssd_scan_impl,
                                  return_state=mode == "prefill")


def backbone_apply(params, cfg: ArchConfig, h, *, mode: str = "train",
                   caches=None, cache_index=None, positions=None,
                   enc_h=None, remat: bool = True, ssd_scan_impl=None,
                   prefill_cache_len=None, cache_write_mask=None,
                   paged_table=None, tp_axis=None):
    """Run the backbone. h: (b, s, d) hidden states (already embedded or
    projected).

    mode: "train" | "prefill" | "decode". remat=True recomputes each
        group in the training backward (`torch.utils.checkpoint`, same
        math; the shared block's leaves are passed in, so its gradient
        sums every group's call).
    positions: (b, s) absolute positions; default 0..s-1, or cache_index
        for every token in decode.
    caches, cache_index: decode state (`init_decode_caches`), updated in
        place. Serving passes cache_index=None with explicit positions:
        each token inserts at its own position.
    cache_write_mask: (b, s) bool; tokens whose cache and state writes
        are exact no-ops (inactive slots, padded chunk tails).
    paged_table: (b, max_blocks) block tables; full-attention caches are
        then shared block pools (`repro_torch.serving.cache`).
    enc_h: (b, t, d) encoder or image states for the cross sublayers
        (train and prefill; decode reads the cross caches).
    prefill_cache_len: the slots of prefill's full-attention caches
        (default s).
    tp_axis: Megatron tensor parallelism of the dense feed-forward
        blocks over the model group ("model", or a process group):
        `params` then hold the model-axis SHARDS of w_in/w_gate/w_out
        (`sharding.rules.tp_leaf_dim`).
    Returns dict(h=..., aux=..., caches=...): aux the sum of the MoE
    load-balance losses over the sublayers; the prefill caches, the
    updated decode caches, or None."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if mode == "decode" and caches is None:
        raise ValueError("decode needs caches")
    pattern = cfg.group_pattern
    b, s, _ = h.shape
    if positions is None and mode == "decode":
        if cache_index is None:
            raise ValueError("decode needs positions or cache_index")
        positions = torch.full((b, s), int(cache_index), device=h.device)
    cache_len = prefill_cache_len if prefill_cache_len is not None else s
    inv_freq = (nn.rope_frequencies(cfg.resolved_head_dim,
                                    base=cfg.rope_base, device=h.device)
                if any(kind in _ATTN for kind in pattern) else None)

    def group_body(h, params_g, shared_params, caches_g, enc_h=enc_h):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        new = {}
        for i, kind in enumerate(pattern):
            h, aux_i, new_i = _run_sublayer(
                params_g[f"sub{i}"], cfg, kind, h, inv_freq=inv_freq,
                positions=positions,
                cache=None if caches_g is None else caches_g[f"sub{i}"],
                cache_index=cache_index, enc_h=enc_h,
                shared_params=shared_params,
                mode=mode, cache_len=cache_len,
                ssd_scan_impl=ssd_scan_impl,
                cache_write_mask=cache_write_mask, paged_table=paged_table,
                tp_axis=tp_axis)
            aux = aux + aux_i
            if new_i is not None:
                new[f"sub{i}"] = new_i
        return h, aux, new

    shared = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    prefilled = []
    for g in range(cfg.n_groups_stack):
        params_g = tree_index(params["groups"], g)
        caches_g = tree_index(caches, g) if mode == "decode" else None
        if mode == "train" and remat and torch.is_grad_enabled():
            h, aux_g, _ = checkpoint(group_body, h, params_g, shared, None,
                                     enc_h, use_reentrant=False)
        else:
            h, aux_g, new = group_body(h, params_g, shared, caches_g)
            prefilled.append(new)
        aux = aux + aux_g
    h = blocks._norm_apply(cfg, params["final_norm"], h)
    if mode == "prefill":
        caches = tree_stack(prefilled)
    return {"h": h, "aux": aux, "caches": None if mode == "train" else caches}


def cross_decode_kv(params, cfg: ArchConfig, enc_h):
    """Every cross sublayer's projected k/v of the encoder or image
    states enc_h (b, t, d): {"subI": {"k": (G, b, t, kv, hd), "v"}}, so a
    serving engine fills its per-slot cross caches once (decode then
    attends through them) without a prefill."""
    out = {}
    for i, kind in enumerate(cfg.group_pattern):
        if kind != "cross":
            continue
        attn = params["groups"][f"sub{i}"]["attn"]
        kvs = [nn.attention_kv(tree_index(attn, g), enc_h,
                               n_kv_heads=cfg.n_kv_heads,
                               qk_norm=cfg.qk_norm)
               for g in range(cfg.n_groups_stack)]
        out[f"sub{i}"] = tree_stack(kvs)
    return out


def fill_cross_caches(caches, params, cfg: ArchConfig, enc_feats):
    """Fill the cross sublayers' caches of `caches` (init_decode_caches'
    tree, any batch) in place from the frontend's features enc_feats
    (1, t, d): the encoder over them (encdec) or the image embeddings
    themselves (vlm), projected through each cross sublayer's k/v and
    copied into every slot. `params` are the generator's (its "encoder"
    and its backbone's cross sublayers are read)."""
    with torch.no_grad():
        enc_h = (encoder_apply(params["encoder"], cfg, enc_feats,
                               remat=False)
                 if cfg.family == "encdec" else enc_feats)
        for name, kv in cross_decode_kv(params["backbone"], cfg,
                                        enc_h).items():
            for leaf, t in caches[name].items():
                t.copy_(kv[leaf][:, :1].to(t.dtype).expand_as(t))


def encoder_apply(params, cfg: ArchConfig, feats, *, remat: bool = True):
    """The bidirectional encoder over stub frame embeddings (b, t, d):
    its layers in turn (RoPE at positions 0..t-1, no mask; in training
    each layer recomputed in the backward when remat), then the final
    norm."""
    b, t, _ = feats.shape
    inv_freq = nn.rope_frequencies(cfg.resolved_head_dim,
                                   base=cfg.rope_base, device=feats.device)
    positions = torch.arange(t, device=feats.device).expand(b, t)

    def layer_body(h, layer_params):
        return blocks.attn_layer_apply(
            layer_params, cfg, h, window=None, inv_freq=inv_freq,
            positions=positions, causal=False)[0]

    # a named range, so a profile can attribute the encoder's device time
    with torch.profiler.record_function("encoder"):
        h = feats
        for i in range(tree_leaves(params["layers"])[0].shape[0]):
            layer = tree_index(params["layers"], i)
            if remat and torch.is_grad_enabled():
                h = checkpoint(layer_body, h, layer, use_reentrant=False)
            else:
                h = layer_body(h, layer)
        return blocks._norm_apply(cfg, params["final_norm"], h)
