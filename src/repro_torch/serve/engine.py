"""Batched serving engine: prefill, then greedy decode, over a request batch.

Counterpart of ``src/repro/serve/engine.py``: fixed batch slots, greedy
sampling.  It runs eagerly under ``torch.inference_mode()`` (the JAX
engine jits its two steps); request routing by XML profile lives in
:mod:`repro_torch.launch.serve` on top of it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..models import transformer as T
from ..models.config import ModelConfig


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises
    (the model never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA card is "
                           f"visible; pass device='cpu' to run on the CPU")
    return dev


@dataclass
class ServeEngine:
    cfg: ModelConfig
    params: Any
    batch: int
    max_len: int
    cache_dtype: Any = torch.bfloat16
    device: Any = "cuda"

    def __post_init__(self) -> None:
        self.device = require_device(self.device)

        def place(tree):
            return {k: place(v) if isinstance(v, dict) else v.to(self.device)
                    for k, v in tree.items()}

        self.params = place(self.params)

    def _tensors(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def generate(self, batch: dict, n_new: int,
                 greedy: bool = True) -> np.ndarray:
        """Prefill ``batch["tokens"]`` (numpy or tensors), then decode
        ``n_new`` tokens greedily (``greedy`` is kept for the JAX engine's
        signature; both always take the argmax).  Returns (batch, n_new)
        int32 tokens; a VLM's positions start after its ``frontend_len``
        patch slots, as in the JAX engine, patches given or not."""
        with torch.inference_mode():
            batch = self._tensors(batch)
            caches = T.init_cache(self.cfg, self.batch, self.max_len,
                                  dtype=self.cache_dtype, device=self.device)
            logits, caches = T.prefill(self.cfg, self.params, batch, caches)
            prompt_len = batch["tokens"].shape[1]
            offset = (self.cfg.frontend_len
                      if self.cfg.family == "vlm" else 0)
            vocab = self.cfg.vocab
            tok = logits[:, -1, :vocab].argmax(-1)[:, None].to(torch.int32)
            out = [tok]
            for i in range(n_new - 1):
                logits, caches = T.decode_step(self.cfg, self.params, tok,
                                               caches,
                                               offset + prompt_len + i)
                tok = logits[:, -1, :vocab].argmax(-1)[:, None].to(
                    torch.int32)
                out.append(tok)
            return torch.cat(out, dim=1).cpu().numpy()
