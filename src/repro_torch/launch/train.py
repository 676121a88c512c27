"""Training CLI of the port: real steps on the card (or the CPU).

Counterpart of ``src/repro/launch/train.py``:

* ``--arch <id> --reduced`` — any zoo architecture at smoke scale
  (``--reduced`` is ``store_true`` with ``default=True``, as in the JAX
  CLI, so ``main`` always builds a reduced model);
* ``--data-filter`` — the paper's XML filter as the ingest stage:
  documents are matched against standing profiles by the port's
  levelwise :class:`~repro_torch.data.filter_stage.FilterStage` before
  byte tokenization (and the vocabulary becomes the 256 bytes);
  ``--data-ingest bytes`` parses and filters raw wire bytes on the device
  (K5, then K6 a level), ``events`` filters host-parsed events (K6);
* fault tolerance — checkpoints, auto-resume, preemption file,
  straggler deadline (:mod:`repro_torch.train.loop`);
* ``--device`` — where the filter and the model run: ``cuda`` (the
  card, which must be present) unless given.

The model's parameters are drawn from
``torch.Generator(device).manual_seed(0)`` where the JAX CLI draws from
``PRNGKey(0)``: the same distributions, not the same values.  The stage's
levelwise engine runs the transition through K6 (``use_kernel=True``),
the port's kernel for the product the JAX engine computes; the kept
documents are the same.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 50 --data-filter --data-ingest bytes --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --data-filter --data-ingest bytes --steps 6
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import ARCHS, get_config
from ..core.dictionary import TagDictionary
from ..core.events import encode_bytes
from ..data.filter_stage import TEXT_FILL, FilterStage
from ..data.generator import DTD, gen_corpus, gen_profiles
from ..data.tokens import TokenPipeline, XMLBytePipeline
from ..models import transformer as T
from ..serve.engine import require_device
from ..train.loop import LoopConfig, run_training
from ..train.optimizer import make_optimizer
from ..train.train_step import make_train_step


def build_filtered_pipeline(batch: int, seq_len: int, log=print,
                            ingest: str = "events", device="cuda"):
    """Pub-sub ingest: generate docs, filter by profiles, route shard 0.

    ``ingest='bytes'`` serializes the corpus to raw wire bytes first and
    runs the whole filter on ``device``
    (``XMLBytePipeline.from_filtered_bytes`` → ``FilterStage.route_bytes``)
    — the paper's same-chip parse+filter feeding LM training.
    """
    dtd = DTD.generate(n_tags=24, seed=0)
    d = TagDictionary()
    dtd.register(d)
    profiles = gen_profiles(dtd, n=64, length=4, seed=0)
    docs = gen_corpus(dtd, n_docs=64, nodes_per_doc=300, seed=0)
    stage = FilterStage(profiles, d, n_shards=1, engine="levelwise",
                        device=str(require_device(device)),
                        engine_options={"use_kernel": True})
    if ingest == "bytes":
        # serialize with the stage's TEXT_FILL so recorded byte volumes
        # (and therefore MB/s) are comparable with the event path, which
        # charges TEXT_FILL synthetic bytes per element in its stats
        payloads = [encode_bytes(doc, text_fill=TEXT_FILL) for doc in docs]
        pipe = XMLBytePipeline.from_filtered_bytes(payloads, stage,
                                                   batch=batch,
                                                   seq_len=seq_len)
        log(f"[train] device-ingest filter kept "
            f"{len(pipe.payloads)}/{len(docs)} documents")
        return pipe
    kept = []
    for routed in stage.route(docs):
        kept += [r.doc_index for r in routed]
    kept = sorted(set(kept))
    log(f"[train] filter stage kept {len(kept)}/{len(docs)} documents "
        f"(selectivity {stage.selectivity(docs):.3f})")
    return XMLBytePipeline([docs[i] for i in kept], batch=batch,
                           seq_len=seq_len)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(ARCHS))
    # as in the JAX CLI: store_true with default True, so always reduced
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data-filter", action="store_true")
    ap.add_argument("--data-ingest", default="events",
                    choices=("events", "bytes"),
                    help="with --data-filter: host-parsed events or raw "
                         "bytes parsed+filtered on device")
    # the JAX CLI's /tmp/repro_train_ckpt, under the temporary directory
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--preempt-file", default="")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override reduced d_model (e.g. ~100M: 768)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the filter and the model run (cuda: the "
                         "card, which must be present; cpu)")
    args = ap.parse_args()
    device = require_device(args.device)

    cfg = get_config(args.arch, reduced=args.reduced)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
        overrides["d_ff"] = 4 * args.d_model
    if args.layers:
        overrides["n_layers"] = args.layers
    if args.data_filter:
        overrides["vocab"] = 256  # byte-level over XML stream
    if overrides:
        cfg = cfg.with_(**overrides)
    print(f"[train] {cfg.name} ({cfg.param_count()/1e6:.1f}M params), "
          f"1 device(s) ({device})")

    params = T.init_model(cfg, torch.Generator(device=device).manual_seed(0))
    opt = make_optimizer(cfg.optimizer, lr=args.lr)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)

    if args.data_filter:
        pipe = build_filtered_pipeline(args.batch, args.seq_len,
                                       ingest=args.data_ingest,
                                       device=device)
    else:
        pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch,
                             seq_len=args.seq_len, seed=0)

    loop = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir,
                      preempt_file=args.preempt_file, log_every=10)
    result = run_training(cfg, loop, params=params, opt_state=opt_state,
                          step_fn=step, batch_fn=pipe.batch_at)
    print(f"[train] done at step {result.final_step}; "
          f"loss {result.losses[0]:.3f} → {result.losses[-1]:.3f}"
          + (f" (resumed from {result.resumed_from})"
             if result.resumed_from else ""))


if __name__ == "__main__":
    main()
