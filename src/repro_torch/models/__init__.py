"""The model zoo on PyTorch (counterpart of ``src/repro/models``).

Families: dense GQA transformers, MLA, MoE (token-choice top-k with
sort-based dispatch), Mamba2/SSD, hybrid (Zamba2), encoder-decoder
(Whisper backbone), VLM (InternVL backbone).  Modality frontends are
stubs, as in the JAX package: the batch carries precomputed frame or
patch embeddings.  Serving (forward, prefill, decode with KV and SSM
caches) and training (``train_loss`` with the chunked cross-entropy and
the MTP head; the optimizers and the step are in :mod:`repro_torch.train`).
"""
from .config import ModelConfig, SHAPES, ShapeSpec  # noqa: F401
