"""Planner constants and the byte model behind root choice.

Copy of the part of the JAX package's ``core/operator.py`` that the
logical planner uses: the message-memory budget before group-axis
streaming, the error for options an engine cannot honor, and the
per-node message-byte estimates that rank candidate roots.
"""
from __future__ import annotations

from repro_torch.core.prepare import Prepared

DEFAULT_MEMORY_BUDGET = 512 << 20  # bytes of message memory before streaming


class UnsupportedPlanOption(ValueError):
    """A plan option the chosen engine (or this port) cannot honor —
    raised instead of silently ignoring the option."""


def node_message_bytes(prep: Prepared) -> dict[str, int]:
    """Estimated message bytes per decomposition-tree node — the currency
    of byte-heuristic root choice and of auto-streaming."""
    deco = prep.decomposition

    def subtree_gattrs(rel: str) -> list[str]:
        out = []
        g = prep.schema.group_of.get(rel)
        if g:
            out.append(g)
        for c in deco.nodes[rel].children:
            out.extend(subtree_gattrs(c))
        return out

    sizes: dict[str, int] = {}
    for rel in deco.order:
        node = deco.nodes[rel]
        if node.parent is None:
            up: tuple[str, ...] = ()
        else:
            up = tuple(
                set(prep.schema.relevant[rel])
                & set(prep.schema.relevant[node.parent])
            )
        size = 8
        for a in list(up) + subtree_gattrs(rel):
            size *= prep.dicts[a].size
        sizes[rel] = size
    return sizes


def peak_message_bytes(prep: Prepared) -> int:
    """Estimated peak message bytes of the leaves-to-root contraction."""
    return max(node_message_bytes(prep).values())
