"""One driver a traffic kind (``traffic/<mix>.json``'s ``"kind"``):
``route`` for closed-loop synchronous requests, ``serve`` for the serve
loop.  A driver builds the stage from the configuration, warms up the
cell's own shapes, runs the window and returns the run's record."""
from __future__ import annotations


def build_stage(config: dict, inputs, *, batch_size: int, device: str):
    """The program under test: a ``FilterStage`` over the configuration's
    engine, delivery and shards, with the run's tag names registered in
    order (tag id ``i`` is ``inputs.tag_names[i]`` on the wire)."""
    from repro_torch.core.dictionary import TagDictionary
    from repro_torch.data.filter_stage import FilterStage

    dictionary = TagDictionary()
    for name in inputs.tag_names:
        dictionary.add(name)
    sparse = config["delivery"] == "sparse"
    options = {"match_cap": config["match_cap"]} if sparse else {}
    return FilterStage(profiles=inputs.profiles, dictionary=dictionary,
                       n_shards=config["shards"], engine=config["engine"],
                       batch_size=batch_size, device=device, sparse=sparse,
                       engine_options=options)


def synchronize(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
