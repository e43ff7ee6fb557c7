"""Graph (DAG) models — the port of ``bigdl_tpu/nn/graph.py`` (ref:
nn/Graph.scala, StaticGraph.scala, utils/Node.scala).

A DAG is built with ``layer.inputs(node, ...)`` (:meth:`Module.inputs`)
from :func:`Input` placeholders, and runs as a topological sweep;
autograd gives the backward. A node with several parents receives the
list of their outputs, like the reference's Activity tables.

Each node registers its module under ``f"{module.name}_node{N}"``, N
from a process-wide counter, as in the JAX package: the same model
built in the two packages, or twice in one process, gets other keys.
:meth:`Graph.load_parameters_dict` / :meth:`Graph.load_states_dict`
therefore carry a tree whose keys are not this graph's by position
(see :meth:`Graph.carry_keys`).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Union

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table


class Node:
    """A vertex: a module and its input edges (ref: utils/Node.scala)."""

    _counter = [0]

    def __init__(self, module: Optional[Module],
                 inputs: Sequence["Node"] = ()):
        self.module = module
        self.inputs = list(inputs)
        Node._counter[0] += 1
        base = module.name if module is not None else "input"
        self.name = f"{base}_node{Node._counter[0]}"

    def __repr__(self):
        return f"Node({self.name})"


def Input(name: Optional[str] = None) -> Node:
    """A placeholder node (ref: nn/Input.scala)."""
    n = Node(None)
    if name:
        n.name = name
    return n


def node_inputs(module: Module, *nodes) -> Node:
    """BigDL's ``layer.inputs(...)``: ``module`` as a node on the given
    parent nodes (a list or tuple of them counts as its elements)."""
    flat: List[Node] = []
    for x in nodes:
        if isinstance(x, (list, tuple)):
            flat.extend(x)
        else:
            flat.append(x)
    return Node(module, flat)


_NODE_NUMBER = re.compile(r"_node(\d+)$")


class Graph(Module):
    """DAG container (ref: nn/StaticGraph.scala).

    ``Graph(inputs=[node, ...], outputs=[node, ...])``. Modules register
    under their node names, in topological order (``_order``). The
    argument is a list, a tuple or — for more than one input — a
    :class:`Table` of the inputs.

    **Weights from another build.** A tree (params or states) whose
    top-level keys are not this graph's node names — the JAX package's
    ``Graph`` of the same model, or this package's built again — is
    carried by position. With ``order``, the source graph's node names
    in its topological order (``[n.name for n in g._order]``), the
    source's k-th node with weights in that order goes to this graph's
    k-th in ``_order``. Without it, both sides are ranked by node number
    N, the order their nodes were made: for two graphs built by the same
    code that pairs each node with the one at its topological position
    too, whatever the counters' offsets. ``load_weights`` with its
    default ``strict=True`` carries nothing: a checkpoint whose node keys
    are not this graph's raises, as in the JAX package. With
    ``strict=False`` it goes through :meth:`load_parameters_dict` and is
    carried by node number.

    A module at two nodes is one module here, with one set of weights
    and their gradient summed over its uses (the reference's sharing);
    the JAX ``Graph`` keeps a copy of its weights a node and
    differentiates each copy alone.
    """

    def __init__(self, inputs: Union[Node, Sequence[Node]],
                 outputs: Union[Node, Sequence[Node]],
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_nodes = [inputs] if isinstance(inputs, Node) else \
            list(inputs)
        self.output_nodes = [outputs] if isinstance(outputs, Node) else \
            list(outputs)
        self._order = self._topo_sort()
        for node in self._order:
            if node.module is not None:
                self._modules[node.name] = node.module

    def _topo_sort(self) -> List[Node]:
        seen: Dict[Node, bool] = OrderedDict()

        def visit(node, stack):
            if node in stack:
                raise ValueError("graph contains a cycle")
            if node in seen:
                return
            for p in node.inputs:
                visit(p, stack + [node])
            seen[node] = True

        for out in self.output_nodes:
            visit(out, [])
        for inp in self.input_nodes:
            if inp not in seen:
                raise ValueError(
                    f"input node {inp.name} unreachable from outputs")
        return list(seen.keys())

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            xs = list(x)
        elif isinstance(x, Table) and len(self.input_nodes) > 1:
            xs = list(x.values())
        else:
            xs = [x]
        if len(xs) != len(self.input_nodes):
            raise ValueError(f"graph expects {len(self.input_nodes)} "
                             f"inputs, got {len(xs)}")
        values = dict(zip(self.input_nodes, xs))
        for node in self._order:
            if node in values:          # an input node
                continue
            parents = [values[p] for p in node.inputs]
            values[node] = node.module(
                parents[0] if len(parents) == 1 else parents)
        outs = [values[n] for n in self.output_nodes]
        return outs[0] if len(outs) == 1 else outs

    # -- weights from another build -------------------------------------------
    def carry_keys(self, tree: Dict, order: Optional[Sequence[str]] = None,
                   which: str = "params") -> Dict:
        """``tree`` re-keyed to this graph's node names. Keys that are
        already this graph's pass as they are; otherwise the source's
        node keys and this graph's nodes that carry ``which``
        (``"params"`` or ``"states"``) are paired by rank: both in
        topological order when ``order`` is given, else both by node
        number (see the class docstring)."""
        mine = [n.name for n in self._order if n.module is not None]
        if set(tree) <= set(mine):
            return tree
        tree_of = (lambda m: m.parameters_dict()) if which == "params" \
            else (lambda m: m.states_dict())
        holders = [n for n in mine if tree_of(self._modules[n])]
        if order is not None:
            theirs = [k for k in order if k in tree]
        else:
            def number(k):
                m = _NODE_NUMBER.search(k)
                if m is None:
                    raise ValueError(
                        f"cannot place {k!r}: not a node key of this graph "
                        "and no node number; pass order=")
                return int(m.group(1))
            theirs = sorted(tree, key=number)
            holders = sorted(holders, key=number)
        if len(theirs) != len(holders):
            raise ValueError(
                f"the tree has {len(theirs)} nodes with {which}, this "
                f"graph {len(holders)}")
        return {mk: tree[tk] for mk, tk in zip(holders, theirs)}

    def load_parameters_dict(self, params, order=None):
        return super().load_parameters_dict(
            self.carry_keys(params, order, "params"))

    def load_states_dict(self, states, order=None):
        return super().load_states_dict(
            self.carry_keys(states, order, "states"))
