"""Batched serving: prefill + greedy decode with a KV cache.

The port of ``repro.launch.serve``: requests are batched, prompts prefilled
in one call, then tokens decoded step by step against the KV cache, which is
written in place.  On ``cuda`` (the default) every norm and attention goes
through the port's CUDA kernels; ``device="cpu"`` runs the plain versions.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --batch 4 --prompt-len 128 --gen 32

serves xlstm-125m, the default arch, as the reference's does.  ``--layers``
cuts the depth: ``--arch jamba-v0.1-52b --full --layers 8`` serves one
period of jamba's pattern at full width (its 32 layers, 103 GB in bf16, do
not fit on one 80 GB card), and ``--arch qwen1.5-110b --full --layers 8``
a tenth of qwen's 80 (222 GB in bf16).  An encoder-decoder model
(seamless-m4t-medium) is given frame embeddings and a vision model
(internvl2-1b) patch embeddings, drawn as the reference draws them (see
:func:`make_frontend`).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._bridge import resolve_device
from repro_torch.configs import KNOWN, get_config
from repro_torch.kernels import ops as kops
from repro_torch.models import Model

from .steps import make_prefill_step, make_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    """Random int32 prompts [batch, prompt_len] in [0, vocab), from ``seed + 1``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.randint(
        0, cfg.vocab, (batch, prompt_len), generator=gen, device=dev, dtype=torch.int32
    )


def make_frontend(cfg, batch: int, seed: int, device) -> dict:
    """The frontend's inputs, as the reference's ``serve`` draws them:
    ``src_embeds`` for an encoder-decoder model (from ``seed + 2``) and
    ``patch_embeds`` for a vision model (from ``seed + 3``), each
    ``N(0, 1) · 0.1`` of ``[batch, frontend_len, d_model]`` in ``cfg.dtype``;
    ``{}`` for a model with neither."""
    dev = resolve_device(device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    shape = (batch, cfg.frontend_len, cfg.d_model)
    out = {}
    for name, wanted, offset in (("src_embeds", cfg.is_encoder_decoder, 2),
                                 ("patch_embeds", cfg.frontend == "vision", 3)):
        if wanted:
            gen = torch.Generator(device=dev).manual_seed(seed + offset)
            out[name] = (torch.randn(shape, generator=gen, device=dev) * 0.1).to(dtype)
    return out


def generate(model: Model, params: dict, prompts: torch.Tensor, gen: int, frontend: dict | None = None) -> dict:
    """Prefill ``prompts`` [B, L0] (with ``frontend``, the model's
    ``src_embeds`` or ``patch_embeds``), then decode greedily to ``gen``
    tokens each.

    Returns the reference's dict: ``tokens`` (int32 numpy [B, gen]),
    ``prefill_s``, ``decode_s`` and ``tok_per_s`` (decode tokens a second).
    Each token is moved to the host as it is made, as the reference does.
    """
    dev = model.device
    cfg = model.cfg
    batch, prompt_len = prompts.shape
    prefill = make_prefill_step(model)
    step = make_serve_step(model)
    max_len = prompt_len + gen + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    cache = model.init_cache(batch, max_len)
    if dev.type == "cuda":
        kops.build()  # first use builds the kernels; keep that out of the timings
    _sync(dev)

    with torch.inference_mode():
        t0 = time.monotonic()
        next_tok, cache = prefill(params, {"tokens": prompts, **(frontend or {})}, cache)
        _sync(dev)
        t_prefill = time.monotonic() - t0

        out = [next_tok[:, None].cpu()]
        tok = next_tok[:, None]
        t0 = time.monotonic()
        for _ in range(gen - 1):
            tok, cache = step(params, cache, tok)
            out.append(tok.cpu())
        _sync(dev)
        t_decode = time.monotonic() - t0

    tokens = torch.cat(out, dim=1).numpy().astype(np.int32)
    tps = batch * (gen - 1) / t_decode if t_decode > 0 else float("inf")
    return {
        "tokens": tokens,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": tps,
    }


def serve(
    arch: str,
    *,
    smoke: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    seed: int = 0,
    device="cuda",
    n_layers: int | None = None,
) -> dict:
    """Serve ``arch`` with random weights from ``seed``; see :func:`generate`.

    ``n_layers`` cuts the config's depth (a whole number of its pattern)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    prompts = make_prompts(cfg, batch, prompt_len, seed, dev)
    res = generate(model, params, prompts, gen, make_frontend(cfg, batch, seed, dev))
    print(
        f"[serve] arch={cfg.name} device={dev} batch={batch} prefill={prompt_len} "
        f"gen={gen}: prefill {res['prefill_s'] * 1e3:.1f} ms, "
        f"decode {res['decode_s'] * 1e3:.1f} ms ({res['tok_per_s']:.1f} tok/s)"
    )
    return res


def main() -> None:
    ap = argparse.ArgumentParser(
        description=(
            "Serve a model with the PyTorch/CUDA port: prefill + greedy decode. "
            f"Archs: {', '.join(sorted(KNOWN))}."
        )
    )
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false", help="full width")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    args = ap.parse_args()
    serve(
        args.arch,
        smoke=args.smoke,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen=args.gen,
        device=args.device,
        n_layers=args.layers,
    )


if __name__ == "__main__":
    main()
