"""Skeletons: named body-part nodes and directed body edges.

The part of :mod:`sleap_tpu.core.skeleton` that inference needs, in plain
Python (no ``networkx``, no ``attr``): nodes in order, body edges in
insertion order, and the jsonpickle form of ``training_config.json``
skeletons, where a node is first written as ``{"py/object": ...,
"py/state": ...}`` and later referred to as ``{"py/id": N}``, N counting
decoded objects (nodes and edge types) from 1 in order of appearance.
Symmetry edges are decoded, to keep that count, and dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

BODY_EDGE = 1  # EdgeType.BODY; 2 is EdgeType.SYMMETRY


@dataclass(eq=False)
class Node:
    """A body part. Two nodes are the same node only if they are the same
    object, as in the JAX package."""

    name: str
    weight: float = 1.0


class Skeleton:
    """Nodes and directed body edges, compared by identity."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or "Skeleton"
        self.nodes: List[Node] = []
        self.edges: List[Tuple[Node, Node]] = []

    def __repr__(self) -> str:
        return f"Skeleton(name={self.name!r}, nodes={self.node_names!r}, edges={self.edge_names!r})"

    @property
    def node_names(self) -> List[str]:
        return [n.name for n in self.nodes]

    @property
    def edge_names(self) -> List[Tuple[str, str]]:
        return [(s.name, d.name) for s, d in self.edges]

    def find_node(self, name: str) -> Optional[Node]:
        return next((n for n in self.nodes if n.name == name), None)

    def add_node(self, name: str) -> None:
        if not isinstance(name, str):
            raise TypeError("Node name must be a string.")
        if self.find_node(name) is not None:
            raise ValueError(f"Skeleton already has a node named ({name}).")
        self.nodes.append(Node(name))

    def add_edge(self, source: str, destination: str) -> None:
        src, dst = self.find_node(source), self.find_node(destination)
        if src is None:
            raise ValueError(f"Skeleton does not have source node named ({source}).")
        if dst is None:
            raise ValueError(f"Skeleton does not have destination node named ({destination}).")
        if (src, dst) in self.edges:
            raise ValueError(f"Skeleton already has an edge between ({source}) and ({destination}).")
        self.edges.append((src, dst))

    # ------------------------------------------------------------------ #
    # jsonpickle form
    # ------------------------------------------------------------------ #

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Skeleton":
        """Decode a node-link dict whose nodes are jsonpickle records.

        Nodes keep their declared order (nodes that only edges name come
        after, in order of appearance). Body edges are ordered by their
        ``edge_insert_idx``, those without one last, ties by the source
        node's position and then by order of appearance: the order of the
        JAX package's graph.
        """
        if "nx_graph" in d:  # template skeletons wrap the node-link dict
            d = d["nx_graph"]
        objects: List[Any] = []
        links = []
        for link in d.get("links", []):
            src = _decode_node(link["source"], objects)
            dst = _decode_node(link["target"], objects)
            etype = _decode_edge_type(link["type"], objects)
            links.append((link.get("edge_insert_idx"), src, dst, etype))
        skel = cls(name=d.get("graph", {}).get("name"))
        for nd in d.get("nodes", []):
            node = _decode_node(nd["id"], objects)
            if not any(node is n for n in skel.nodes):
                skel.nodes.append(node)
        for _, src, dst, _ in links:
            for node in (src, dst):
                if not any(node is n for n in skel.nodes):
                    skel.nodes.append(node)
        position = {id(n): i for i, n in enumerate(skel.nodes)}
        body = [
            (idx, position[id(src)], order, src, dst)
            for order, (idx, src, dst, etype) in enumerate(links)
            if etype == BODY_EDGE
        ]
        body.sort(key=lambda t: (t[0] is None, t[0] or 0, t[1], t[2]))
        skel.edges = [(src, dst) for *_, src, dst in body]
        return skel

    def to_dict(self) -> Dict[str, Any]:
        """Encode in the jsonpickle form :meth:`from_dict` reads."""
        ids: Dict[int, int] = {}

        def encode(obj, first_form):
            if id(obj) in ids:
                return {"py/id": ids[id(obj)]}
            ids[id(obj)] = len(ids) + 1
            return first_form

        def node(n: Node):
            return encode(n, {"py/object": "sleap.skeleton.Node",
                              "py/state": {"py/tuple": [n.name, n.weight]}})

        body_type = object()
        links = []
        for i, (src, dst) in enumerate(self.edges):
            links.append({
                "edge_insert_idx": i,
                "key": 0,
                "source": node(src),
                "target": node(dst),
                "type": encode(body_type, {"py/reduce": [{"py/type": "sleap.skeleton.EdgeType"},
                                                         {"py/tuple": [BODY_EDGE]}]}),
            })
        return {
            "directed": True,
            "graph": {"name": self.name, "num_edges_inserted": len(self.edges)},
            "links": links,
            "multigraph": True,
            "nodes": [{"id": node(n)} for n in self.nodes],
        }


def _decode_node(encoded: Any, objects: List[Any]) -> Node:
    if isinstance(encoded, str):
        node = Node(encoded)
    elif isinstance(encoded, dict) and "py/object" in encoded:
        state = encoded["py/state"]
        if "py/tuple" in state:
            node = Node(name=state["py/tuple"][0], weight=state["py/tuple"][1])
        else:
            node = Node(name=state["name"], weight=state.get("weight", 1.0))
    elif isinstance(encoded, dict) and "py/id" in encoded:
        return objects[encoded["py/id"] - 1]
    else:
        raise ValueError(f"Cannot decode node record: {encoded!r}")
    objects.append(node)
    return node


def _decode_edge_type(encoded: Any, objects: List[Any]) -> int:
    if isinstance(encoded, int):
        return encoded
    if "py/reduce" in encoded:
        etype = encoded["py/reduce"][1]["py/tuple"][0]
        objects.append(etype)
        return etype
    if "py/id" in encoded:
        return objects[encoded["py/id"] - 1]
    raise ValueError(f"Cannot decode edge type record: {encoded!r}")
