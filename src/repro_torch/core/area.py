# Copy of src/repro/core/area.py (the port imports nothing of the JAX package).
"""FPGA area model — the Fig-8 reproduction (§4.1).

FPGA "area" (LUTs/FFs) has no direct TPU meaning, so the paper's area
experiment is reproduced with an explicit *hardware cost model* counting
bit-comparator equivalents per NFA block, the same unit the paper's own
optimizations act on:

* a tag matcher without the pre-decoder costs 8 bit-comparators per
  character (Fig 6); with the §3.4 pre-decoder it costs 1 per character
  (Fig 7) plus a one-time shared 256-line decoder;
* an ancestor-descendant step adds the waiting block and a negation
  (close-tag) matcher (Fig 3);
* a parent-child step adds a TOS compare against the 12-bit tag id; the
  tag stack itself is shared once per stream (Fig 4);
* common-prefix sharing (§3.3) is modelled by building the shared vs.
  unshared NFA and costing each state once.

The same module also reports the *measured* TPU analogue: bytes of
transition tables / working set per engine, used by benchmarks/bench_area.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from .dictionary import CLOSE_NBYTES, OPEN_NBYTES, TagDictionary
from .nfa import K_LOOP, K_MATCH, NFA, WILD_TAG, compile_queries
from .xpath import Query

# Virtex-4 LX200 logic capacity (paper's target device, §3.5):
# 89,088 slices × 2 LUTs — used to express model cost as chip %.
VIRTEX4_LX200_LUTS = 178_176

SCENARIOS = ("Unop", "Com-P", "Unop-CharDec", "Com-P-CharDec")

TAG_ID_BITS = 12          # 4096-entry dictionary (§3.1)
STACK_DEPTH = 64          # shared document stack depth
FF_COST = 1               # one flip-flop per state
WAIT_CLASS_COST = 16      # [<\c\d>]* char-class logic, full comparators
WAIT_CLASS_COST_DEC = 2   # …with pre-decoded class lines
CHARDEC_COST = 2048       # shared 256-way decoder (256 × 8-bit compare)


@dataclass(frozen=True)
class AreaReport:
    scenario: str
    n_queries: int
    n_states: int
    bit_cost: int
    part: int | None = None  # partition index for sharded plans (per-FPGA)

    @property
    def chip_fraction(self) -> float:
        return self.bit_cost / VIRTEX4_LX200_LUTS


def _matcher_cost(nbytes: int, chardec: bool) -> int:
    return nbytes * (1 if chardec else 8)


def nfa_bit_cost(nfa: NFA, *, chardec: bool) -> int:
    """Cost of one compiled NFA under the block-level model."""
    t = nfa.tables
    cost = CHARDEC_COST if chardec else 0
    any_child = False
    for s in range(1, t.in_state.shape[0]):
        kind = int(t.kind[s])
        cost += FF_COST
        if kind == K_MATCH:
            if int(t.in_tag[s]) == WILD_TAG:
                cost += _matcher_cost(2, chardec)   # '<' '>' markers only
            else:
                cost += _matcher_cost(OPEN_NBYTES, chardec)
            # parent-child steps: the in-edge source is a match state, not a
            # loop — they carry the TOS compare (Fig 4).
            src_kind = int(t.kind[int(t.in_state[s])])
            if src_kind != K_LOOP:
                # root-anchored first steps also use level-1 check; count it
                cost += TAG_ID_BITS
                any_child = True
        elif kind == K_LOOP:
            # waiting block + negation (close-tag) matcher
            cost += (WAIT_CLASS_COST_DEC if chardec else WAIT_CLASS_COST)
            cost += _matcher_cost(CLOSE_NBYTES, chardec)
    # shared stack (once per stream) if any stack-group profile exists
    if any_child:
        cost += STACK_DEPTH * TAG_ID_BITS
    # output priority encoders (two: stack group and regex group, §3.5)
    q = nfa.n_queries
    cost += q * max(1, math.ceil(math.log2(max(q, 2))))
    return cost


def area_report(queries: Sequence[Query], dictionary: TagDictionary,
                scenario: str) -> AreaReport:
    if scenario not in SCENARIOS:
        raise ValueError(scenario)
    shared = scenario.startswith("Com-P")
    chardec = scenario.endswith("CharDec")
    nfa = compile_queries(list(queries), dictionary, shared=shared)
    return AreaReport(
        scenario=scenario,
        n_queries=len(queries),
        n_states=nfa.n_states,
        bit_cost=nfa_bit_cost(nfa, chardec=chardec),
    )


def area_report_sharded(queries: Sequence[Query], dictionary: TagDictionary,
                        scenario: str, n_parts: int) -> list[AreaReport]:
    """Per-part area of a partitioned profile set — one row per part.

    The paper's area model is per-FPGA; partitioning the query set
    across chips (§3.5, the multi-chip scaling table) makes the cost of
    each chip the cost of *its* sub-NFA.  Balanced partitions show up
    here directly: the max row bounds the required device, the sum is
    the total silicon.  Shared-prefix dedup happens within a part (the
    partitioner keeps prefix groups together precisely so this cost
    does not explode versus the monolithic NFA).
    """
    from .nfa import partition_queries

    if scenario not in SCENARIOS:
        raise ValueError(scenario)
    shared = scenario.startswith("Com-P")
    chardec = scenario.endswith("CharDec")
    parts, partition = partition_queries(list(queries), n_parts, dictionary,
                                         shared=shared)
    sizes = partition.part_sizes()
    return [
        AreaReport(
            scenario=scenario,
            n_queries=int(sizes[p]),
            n_states=nfa.n_states,
            bit_cost=nfa_bit_cost(nfa, chardec=chardec),
            part=p,
        )
        for p, nfa in enumerate(parts)
    ]


def engine_table_bytes(nfa: NFA) -> dict[str, int]:
    """Measured TPU analogue: bytes of device-resident transition state."""
    s = nfa.n_states
    t = nfa.n_tags
    q = nfa.n_queries
    return {
        # levelwise matmul path: REQ (T,S) f32 + parent one-hot (S,S) f32
        "levelwise_tables": 4 * (t * s + s * s + 4 * s + q),
        # streaming packed path: int32 vectors + uint32 words
        "streaming_tables": 4 * (3 * s + s // 32 + q),
        # per-document working set: stack of packed words
        "streaming_stack": 4 * (STACK_DEPTH + 2) * max(s // 32, 1),
    }
