"""Batched serving driver: prefill a batch of prompts, then greedy-decode
with the KV cache (or the SSM states) — the counterpart of
``repro/launch/serve.py``, for every family of the zoo. The audio family
is given zero frame embeddings (B, encoder_seq, D) and the VLM family
zero patch embeddings (B, num_vision_tokens, D), f32, as in the JAX
package's server (their frontends are stubs).

The prefill and decode steps are the model's own (``models/zoo.py``), run
eagerly under ``torch.inference_mode()``. The cache's position is a Python
int and the greedy argmax stays on the device: each token's ids feed the
next step as a tensor, and the generated ids are copied to the host once,
at the end, so a ``generate`` makes no host sync per token. ``kernel``
picks how K4 (``attention_impl="flash"``) and K3 (the SSD scan) run.

    python -m repro_torch.launch.serve --arch mamba2-370m --device cpu
    python -m repro_torch.launch.serve --arch mamba2-370m --no-smoke \\
        --batch 8 --prompt-len 512 --gen 32               # on the card
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data.synthetic import synthetic_tokens
from ..device import resolve_device
from ..models import build_model


def frontend_inputs(cfg, batch_size: int, device) -> dict:
    """The stub frontends' inputs a batch carries beside its tokens, as
    ``repro/launch/serve.py`` gives them: zero f32 frame embeddings (B, encoder_seq,
    D) for the audio family, zero patch embeddings (B, num_vision_tokens,
    D) for the VLM family, nothing for the others."""
    if cfg.family == "audio":
        return {"audio_embeds": torch.zeros(
            (batch_size, cfg.encoder_seq, cfg.d_model), device=device)}
    if cfg.family == "vlm":
        return {"vision_embeds": torch.zeros(
            (batch_size, cfg.num_vision_tokens, cfg.d_model), device=device)}
    return {}


class BatchedServer:
    """Greedy batched decode over a fixed cohort of requests."""

    def __init__(self, cfg, params=None, seed: int = 0, *, device="cuda",
                 kernel: str = "auto"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, kernel=kernel)
        self.params = params if params is not None else self.model.init(
            torch.Generator().manual_seed(seed), device=self.device)

    def generate(self, prompts, max_new_tokens: int) -> np.ndarray:
        """prompts: (B, S) int. Returns (B, max_new_tokens) int32 (one token
        at least, as the JAX driver)."""
        prompts = np.asarray(prompts)
        B, S = prompts.shape
        with torch.inference_mode():
            cache = self.model.init_cache(B, S + max_new_tokens,
                                          device=self.device)
            batch = {"tokens": torch.from_numpy(prompts.astype(np.int64))
                     .to(self.device),
                     **frontend_inputs(self.cfg, B, self.device)}
            logits, cache = self.model.prefill(self.params, batch, cache)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            out = [tok]
            for _ in range(max_new_tokens - 1):
                logits, cache = self.model.decode_step(self.params, cache,
                                                       {"tokens": tok})
                tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                out.append(tok)
            return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def main(argv=None):
    from ..configs import get_config, get_smoke_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced smoke config (--no-smoke: full width)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    srv = BatchedServer(cfg, device=args.device)
    stream = synthetic_tokens(args.batch * args.prompt_len + 1,
                              cfg.vocab_size, seed=3)
    prompts = stream[:args.batch * args.prompt_len].reshape(
        args.batch, args.prompt_len)

    t0 = time.time()
    toks = srv.generate(prompts, args.gen)
    dt = time.time() - t0
    print(f"arch={cfg.name} device={srv.device} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}: {toks.size / dt:.1f} "
          f"tok/s  first row: {toks[0][:10].tolist()}")


if __name__ == "__main__":
    main()
