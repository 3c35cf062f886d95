"""Skeletons: named body-part nodes, directed body edges and symmetries.

The part of :mod:`sleap_tpu.core.skeleton` that inference and training
need, in plain Python (no ``networkx``, no ``attr``): nodes in order, body
edges in insertion order, symmetric node pairs (which flip augmentation
swaps, :meth:`Skeleton.flip_idx`), and the jsonpickle form of
``training_config.json`` skeletons, where a node is first written as
``{"py/object": ..., "py/state": ...}`` and later referred to as
``{"py/id": N}``, N counting decoded objects (nodes and edge types) from 1
in order of appearance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

BODY_EDGE = 1  # EdgeType.BODY
SYMMETRY_EDGE = 2  # EdgeType.SYMMETRY


@dataclass(eq=False)
class Node:
    """A body part. Two nodes are the same node only if they are the same
    object, as in the JAX package."""

    name: str
    weight: float = 1.0


class Skeleton:
    """Nodes, directed body edges and symmetric node pairs, compared by
    identity."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or "Skeleton"
        self.nodes: List[Node] = []
        self.edges: List[Tuple[Node, Node]] = []
        # Unordered symmetric pairs in the order they were added.
        self._symmetry_links: List[Tuple[Node, Node]] = []

    def __repr__(self) -> str:
        return f"Skeleton(name={self.name!r}, nodes={self.node_names!r}, edges={self.edge_names!r})"

    @property
    def node_names(self) -> List[str]:
        return [n.name for n in self.nodes]

    @property
    def edge_names(self) -> List[Tuple[str, str]]:
        return [(s.name, d.name) for s, d in self.edges]

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def edge_inds(self) -> List[Tuple[int, int]]:
        """Body edges as (source, destination) node-index pairs."""
        position = {id(n): i for i, n in enumerate(self.nodes)}
        return [(position[id(s)], position[id(d)]) for s, d in self.edges]

    @property
    def symmetries(self) -> List[Tuple[Node, Node]]:
        """Unique symmetric pairs, in the JAX package's graph order: by the
        earlier node's position, that node first."""
        out, seen = [], set()
        for node in self.nodes:
            for a, b in self._symmetry_links:
                if node is not a and node is not b:
                    continue
                key = frozenset((id(a), id(b)))
                if key not in seen:
                    seen.add(key)
                    out.append((node, b if node is a else a))
        return out

    @property
    def symmetry_names(self) -> List[Tuple[str, str]]:
        return [(a.name, b.name) for a, b in self.symmetries]

    @property
    def symmetric_inds(self) -> List[Tuple[int, int]]:
        position = {id(n): i for i, n in enumerate(self.nodes)}
        return [(position[id(a)], position[id(b)]) for a, b in self.symmetries]

    def flip_idx(self) -> List[int]:
        """Per-node index of the symmetric partner (itself where unpaired)."""
        idx = list(range(self.n_nodes))
        for a, b in self.symmetric_inds:
            idx[a], idx[b] = b, a
        return idx

    def get_symmetry(self, name: str) -> Optional[Node]:
        node = self.find_node(name)
        for a, b in self.symmetries:
            if a is node:
                return b
            if b is node:
                return a
        return None

    def add_symmetry(self, node1: str, node2: str) -> None:
        if node1 == node2:
            raise ValueError("Cannot add symmetry to the same node.")
        for name in (node1, node2):
            other = self.get_symmetry(name)
            if other is not None:
                raise ValueError(f"{name} is already symmetric with {other.name}.")
        a, b = self.find_node(node1), self.find_node(node2)
        if a is None or b is None:
            raise ValueError("Both nodes must exist to add a symmetry.")
        self._symmetry_links.append((a, b))

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
    def from_dict(cls, d: Dict[str, Any], node_list: Optional[List[Node]] = None) -> "Skeleton":
        """Decode a node-link dict whose nodes are jsonpickle records, or
        integer indices into ``node_list`` (the ``.slp`` form, whose nodes
        all skeletons of a file share).

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
            src = _decode_node(link["source"], objects, node_list)
            dst = _decode_node(link["target"], objects, node_list)
            etype = _decode_edge_type(link["type"], objects)
            links.append((link.get("edge_insert_idx"), src, dst, etype))
        skel = cls(name=d.get("graph", {}).get("name"))
        for nd in d.get("nodes", []):
            node = _decode_node(nd["id"], objects, node_list)
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
        seen = set()
        for _, src, dst, etype in links:
            key = frozenset((id(src), id(dst)))
            if etype != BODY_EDGE and key not in seen:
                seen.add(key)
                skel._symmetry_links.append((src, dst))
        return skel

    def to_dict(self, node_to_idx: Optional[Dict[int, int]] = None) -> Dict[str, Any]:
        """Encode in the form :meth:`from_dict` reads: body edges, then each
        symmetry as two directed links, as the JAX package writes. Nodes are
        jsonpickle records, or with ``node_to_idx`` (``id(node)`` -> index)
        the integer indices of a ``.slp`` file's shared node list."""
        ids: Dict[int, int] = {}

        def encode(obj, first_form):
            if id(obj) in ids:
                return {"py/id": ids[id(obj)]}
            ids[id(obj)] = len(ids) + 1
            return first_form

        def node(n: Node):
            if node_to_idx is not None:
                return node_to_idx[id(n)]
            return encode(n, {"py/object": "sleap.skeleton.Node",
                              "py/state": {"py/tuple": [n.name, n.weight]}})

        edge_types = {BODY_EDGE: object(), SYMMETRY_EDGE: object()}

        def edge_type(t: int):
            return encode(edge_types[t], {"py/reduce": [{"py/type": "sleap.skeleton.EdgeType"},
                                                        {"py/tuple": [t]}]})

        links = []
        for i, (src, dst) in enumerate(self.edges):
            links.append({
                "edge_insert_idx": i,
                "key": 0,
                "source": node(src),
                "target": node(dst),
                "type": edge_type(BODY_EDGE),
            })
        for src, dst in self.symmetries:
            for a, b in ((src, dst), (dst, src)):
                links.append({"key": 0, "source": node(a), "target": node(b),
                              "type": edge_type(SYMMETRY_EDGE)})
        return {
            "directed": True,
            "graph": {"name": self.name, "num_edges_inserted": len(self.edges)},
            "links": links,
            "multigraph": True,
            "nodes": [{"id": node(n)} for n in self.nodes],
        }


def _decode_node(encoded: Any, objects: List[Any], node_list: Optional[List[Node]] = None) -> Node:
    if isinstance(encoded, int):
        if node_list is None:
            raise ValueError("Integer node reference without a node list.")
        return node_list[encoded]
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
