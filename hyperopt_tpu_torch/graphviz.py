"""Render pyll space graphs to Graphviz dot text (the port's copy of
:mod:`hyperopt_tpu.graphviz`): a dot description of a search-space
expression, hyperparameter nodes highlighted and switch edges labeled by
branch index.  Pure text emission; no graphviz binary dependency.
"""

from __future__ import annotations

from .pyll.base import Literal, as_apply, dfs

__all__ = ["dot_hyperparameters"]


def _node_label(node):
    if isinstance(node, Literal):
        text = repr(node.obj)
        if len(text) > 20:
            text = text[:17] + "..."
        return text.replace('"', "'")
    return node.name


def dot_hyperparameters(expr):
    """Return a dot-format string for the graph rooted at ``expr``."""
    expr = as_apply(expr)
    nodes = dfs(expr)
    ids = {id(n): f"n{i}" for i, n in enumerate(nodes)}
    lines = [
        "digraph space {",
        "  rankdir=TB;",
        '  node [fontsize=10, shape=box, style=rounded];',
    ]
    for n in nodes:
        nid = ids[id(n)]
        label = _node_label(n)
        attrs = f'label="{label}"'
        if n.name == "hyperopt_param":
            param_label = n.pos_args[0].obj if n.pos_args else "?"
            attrs = (
                f'label="{param_label}", shape=ellipse, style=filled, '
                'fillcolor=lightblue'
            )
        elif n.name == "switch":
            attrs = f'label="switch", shape=diamond'
        elif isinstance(n, Literal):
            attrs = f'label="{label}", shape=plaintext'
        lines.append(f"  {nid} [{attrs}];")
    for n in nodes:
        nid = ids[id(n)]
        for i, child in enumerate(n.pos_args):
            edge = ""
            if n.name == "switch" and i > 0:
                edge = f' [label="{i - 1}"]'
            lines.append(f"  {ids[id(child)]} -> {nid}{edge};")
        for key, child in n.named_args:
            lines.append(f'  {ids[id(child)]} -> {nid} [label="{key}"];')
    lines.append("}")
    return "\n".join(lines)
