"""Serve steps: prefill (prompt -> cache) and decode (one token against
the cache), and `generate`, which drives them under
`torch.inference_mode()` (`torch.no_grad()` on a mesh).

Greedy decoding follows the reference token for token. Sampling
(`temperature > 0`) draws from an explicit `torch.Generator` where the
reference splits a `jax.random` key, so the two packages' samples differ.
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import rwkv6, whisper, zamba2
from repro_torch.models.sharding import (NO_MESH, MeshRules, inference,
                                         serving)


def make_decode_step(cfg: ArchConfig, rules: MeshRules = NO_MESH,
                     chunk: int = 4096):
    """(params, token, cache[, pos3]) -> (logits, new_cache)."""
    def decode_step(params, token, cache, pos3=None):
        return M.decode_step(params, cfg, token, cache, rules=rules,
                             chunk=chunk, pos3=pos3)
    return decode_step


def make_prefill(cfg: ArchConfig, rules: MeshRules = NO_MESH,
                 chunk: int = 1024, max_len: int | None = None):
    """(params, batch) -> (last logits, serve state). A decoder-only cache
    holds `max_len` positions (default: the prompt and 64 more; rwkv6's
    state does not grow); whisper encodes `batch["frames"]`, computes the
    cross K/V once and decodes the prompt into a self cache of
    `max_decoder_len`, returning {"self", "xk", "xv"}."""
    mod = M.family_module(cfg)

    def prefill(params, batch):
        with inference(rules):
            return _prefill(params, batch)

    def _prefill(params, batch):
        if cfg.is_encoder_decoder:
            frames = batch["frames"]
            memory = whisper.encode(params, cfg, frames, rules=rules,
                                    chunk=chunk, remat=False)
            xk, xv = whisper.cross_kv(params, cfg, memory, rules=rules)
            cache = whisper.init_self_cache(cfg, frames.shape[0],
                                            cfg.max_decoder_len, rules,
                                            device=frames.device)
            logits, cache = whisper.decode(
                params, cfg, batch["tokens"], xk=xk, xv=xv, self_cache=cache,
                rules=rules, chunk=chunk, remat=False)
            return logits[:, -1], {"self": cache, "xk": xk, "xv": xv}
        tokens = batch["tokens"]
        ml = max_len or tokens.shape[1] + 64
        if mod is rwkv6:
            return mod.prefill(params, cfg, tokens, rules=rules)
        if mod is zamba2:
            return mod.prefill(params, cfg, tokens, ml, rules=rules,
                               attn_chunk=chunk)
        return mod.prefill(
            params, cfg, tokens, ml, rules=rules, chunk=chunk,
            pos3=batch.get("pos3"), vision_embeds=batch.get("vision_embeds"))
    return prefill


def make_whisper_decode_step(cfg: ArchConfig, rules: MeshRules = NO_MESH,
                             chunk: int = 4096):
    """(params, token, {"self", "xk", "xv"}) -> (logits, new state); the
    self cache is written in place."""
    def decode_step(params, token, cache):
        with inference(rules):
            logits, self_new = whisper.decode(
                params, cfg, token[:, None], xk=cache["xk"], xv=cache["xv"],
                self_cache=cache["self"], rules=rules, chunk=chunk,
                remat=False)
            return logits[:, 0], {"self": self_new, "xk": cache["xk"],
                                  "xv": cache["xv"]}
    return decode_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@serving
def generate(params, cfg: ArchConfig, batch: dict, steps: int, *,
             rules: MeshRules = NO_MESH, chunk: int = 1024,
             temperature: float = 0.0, key: torch.Generator | None = None,
             device=None, step_times: list | None = None) -> torch.Tensor:
    """Greedy (or, with `temperature > 0`, sampled from the generator
    `key`) generation. Returns (B, steps) int32 tokens.

    `batch` holds numpy arrays or tensors ("tokens" (B, T), optionally
    "pos3" (3, B, T) and "vision_embeds"; whisper also takes "frames"
    (B, T_enc, d)); they are moved to `device`
    (`None` = the card; raises without one), where `params` must lie.
    With a list `step_times`, the host seconds of the prefill and of each
    decode step are appended, each ended by a device synchronize."""
    dev = resolve_device(device)
    if temperature > 0 and key is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator "
                         "`key`")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    prompt_len = batch["tokens"].shape[1]
    prefill = make_prefill(cfg, rules, chunk=chunk,
                           max_len=prompt_len + steps)
    if cfg.is_encoder_decoder:
        step_fn = make_whisper_decode_step(cfg, rules, chunk)
    else:
        step_fn = make_decode_step(cfg, rules, chunk)

    def clocked(fn, *args):
        if step_times is None:
            return fn(*args)
        tic = time.perf_counter()
        out = fn(*args)
        _sync(dev)
        step_times.append(time.perf_counter() - tic)
        return out

    logits, cache = clocked(prefill, params, batch)
    outs = []
    b = logits.shape[0]
    for i in range(steps):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            token = torch.multinomial(probs, 1, generator=key)[:, 0]
        else:
            token = torch.argmax(logits, dim=-1)
        token = token.to(torch.int32)
        outs.append(token)
        if cfg.mrope:
            pos3 = torch.full((3, b, 1), prompt_len + i, dtype=torch.int32,
                              device=dev)
            logits, cache = clocked(step_fn, params, token, cache, pos3)
        else:
            logits, cache = clocked(step_fn, params, token, cache)
    return torch.stack(outs, dim=1)
