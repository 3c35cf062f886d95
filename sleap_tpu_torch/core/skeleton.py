"""Skeletons: named body-part nodes, directed body edges and symmetries.

:mod:`sleap_tpu.core.skeleton` in plain Python (no ``networkx``, no
``attr``). The JAX package keeps a skeleton in a ``networkx.MultiDiGraph``;
this module keeps the same multigraph in ordered dicts (node -> successor
-> edge key -> attributes), so nodes, edges and symmetries come out in the
JAX package's order: nodes in insertion order, edges by source node, then
by the order their target was first linked from it, then by key, and body
edges sorted stably by their ``edge_insert_idx``. ``graph`` and
``body_graph`` build the ``networkx`` objects the JAX package returns,
importing ``networkx`` only there.

Two JSON styles are read and written: the ``.slp`` metadata style, whose
nodes are integer indices into a node list that all skeletons of a file
share, and the jsonpickle style of ``training_config.json`` and
:meth:`Skeleton.save_json`, where a node is first written as
``{"py/object": ..., "py/state": ...}`` and later referred to as
``{"py/id": N}``, N counting decoded objects (nodes and edge types) from 1
in order of appearance.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union


class EdgeType:
    """Edge kinds: BODY edges join body parts; SYMMETRY edges pair left and
    right parts for flip augmentation."""

    BODY = 1
    SYMMETRY = 2


@dataclass(eq=False)
class Node:
    """A body part. Two nodes are the same node only if they are the same
    object, as in the JAX package."""

    name: str
    weight: float = 1.0

    @staticmethod
    def from_names(names: Sequence[str]) -> List["Node"]:
        return [Node(name) for name in names]

    def matches(self, other: "Node") -> bool:
        return self.name == other.name and self.weight == other.weight

    def __repr__(self) -> str:
        return f"Node(name={self.name!r}, weight={self.weight})"


def _import_networkx():
    try:
        import networkx
    except ImportError as e:
        raise ImportError(
            "Skeleton.graph and Skeleton.body_graph return networkx graphs and need the "
            "networkx package, which is not installed; the queries (edges, has_edge, "
            "find_neighbors, root_nodes, is_arborescence) need nothing."
        ) from e
    return networkx


class Skeleton:
    """A directed multigraph of nodes with BODY and SYMMETRY edges,
    compared by identity (:meth:`matches` compares structure)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or "Skeleton"
        self._num_edges_inserted = 0
        # node -> successor -> key -> edge attributes, all in insertion order.
        self._adj: Dict[Node, Dict[Node, Dict[int, Dict[str, Any]]]] = {}
        self._node_tuple: Tuple[Node, ...] = ()

    def __repr__(self) -> str:
        return f"Skeleton(name={self.name!r}, nodes={self.node_names!r}, edges={self.edge_names!r})"

    def __contains__(self, node_name: str) -> bool:
        return self.has_node(node_name)

    # ------------------------------------------------------------------ #
    # The multigraph
    # ------------------------------------------------------------------ #
    def _add_graph_node(self, node: Node) -> None:
        if node not in self._adj:
            self._adj[node] = {}
            self._node_tuple = tuple(self._adj)

    def _add_graph_edge(self, src: Node, dst: Node, **attrs) -> None:
        self._add_graph_node(src)
        self._add_graph_node(dst)
        keys = self._adj[src].setdefault(dst, {})
        key = len(keys)
        while key in keys:
            key += 1
        keys[key] = attrs

    def _remove_graph_edge(self, src: Node, dst: Node, key: int) -> None:
        keys = self._adj[src][dst]
        del keys[key]
        if not keys:
            del self._adj[src][dst]

    def _graph_edges(self) -> List[Tuple[Node, Node, int, Dict[str, Any]]]:
        return [(u, v, k, a) for u, nbrs in self._adj.items()
                for v, keys in nbrs.items() for k, a in keys.items()]

    @property
    def graph(self):
        """The skeleton as the JAX package's ``networkx.MultiDiGraph``."""
        nx = _import_networkx()
        g = nx.MultiDiGraph(name=self.name, num_edges_inserted=self._num_edges_inserted)
        g.add_nodes_from(self.nodes)
        for u, v, k, a in self._graph_edges():
            g.add_edge(u, v, key=k, **a)
        return g

    @property
    def body_graph(self):
        """The nodes and body edges as a ``networkx.MultiDiGraph``."""
        nx = _import_networkx()
        g = nx.MultiDiGraph()
        g.add_nodes_from(self.nodes)
        g.add_edges_from(self.edges)
        return g

    @property
    def is_arborescence(self) -> bool:
        """True if the body edges form a tree whose every node has at most
        one parent (networkx's ``is_arborescence`` of :attr:`body_graph`)."""
        nodes = self.nodes
        if not nodes:
            raise ValueError("G has no nodes.")
        edges = self.edges
        if len(edges) != len(nodes) - 1:
            return False
        parents: Dict[int, int] = {}
        for _, dst in edges:
            parents[id(dst)] = parents.get(id(dst), 0) + 1
            if parents[id(dst)] > 1:
                return False
        neighbours: Dict[int, List[Node]] = {id(n): [] for n in nodes}
        for src, dst in edges:
            neighbours[id(src)].append(dst)
            neighbours[id(dst)].append(src)
        seen, stack = {id(nodes[0])}, [nodes[0]]
        while stack:
            for nbr in neighbours[id(stack.pop())]:
                if id(nbr) not in seen:
                    seen.add(id(nbr))
                    stack.append(nbr)
        return len(seen) == len(nodes)

    # ------------------------------------------------------------------ #
    # Nodes
    # ------------------------------------------------------------------ #
    @property
    def nodes(self) -> List[Node]:
        return list(self._node_tuple)

    @property
    def node_names(self) -> List[str]:
        return [n.name for n in self._node_tuple]

    @property
    def n_nodes(self) -> int:
        return len(self._node_tuple)

    def node_to_index(self, node: Union[str, Node]) -> int:
        if isinstance(node, Node):
            return self.nodes.index(node)
        return self.node_names.index(node)

    def find_node(self, name: Union[str, Node]) -> Optional[Node]:
        if isinstance(name, Node):
            name = name.name
        return next((n for n in self._node_tuple if n.name == name), None)

    def has_node(self, name: str) -> bool:
        return self.find_node(name) is not None

    def has_nodes(self, names: Iterable[str]) -> bool:
        return all(self.has_node(n) for n in names)

    def add_node(self, name: str) -> None:
        if not isinstance(name, str):
            raise TypeError("Node name must be a string.")
        if self.has_node(name):
            raise ValueError(f"Skeleton already has a node named ({name}).")
        self._add_graph_node(Node(name))

    def add_nodes(self, names: Iterable[str]) -> None:
        for name in names:
            self.add_node(name)

    def delete_node(self, name: str) -> None:
        node = self.find_node(name)
        if node is None:
            raise ValueError(f"The node named ({name}) isn't in the skeleton.")
        del self._adj[node]
        for nbrs in self._adj.values():
            nbrs.pop(node, None)
        self._node_tuple = tuple(self._adj)

    def relabel_node(self, old_name: str, new_name: str) -> None:
        self.relabel_nodes({old_name: new_name})

    def relabel_nodes(self, mapping: Dict[str, str]) -> None:
        existing = set(self.node_names) - set(mapping.keys())
        for new_name in mapping.values():
            if new_name in existing:
                raise ValueError("Cannot relabel a node to an existing name.")
        for old_name, new_name in mapping.items():
            node = self.find_node(old_name)
            if node is None:
                raise ValueError(f"The node named ({old_name}) isn't in the skeleton.")
            node.name = new_name

    # ------------------------------------------------------------------ #
    # Body edges
    # ------------------------------------------------------------------ #
    def _body_edges_full(self) -> List[Tuple[Node, Node, int, Dict[str, Any]]]:
        edge_list = [
            (a.get("edge_insert_idx", i), u, v, k, a)
            for i, (u, v, k, a) in enumerate(self._graph_edges())
            if a.get("type") == EdgeType.BODY
        ]
        edge_list.sort(key=lambda t: (t[0] is None, t[0] or 0))
        return [(u, v, k, a) for _, u, v, k, a in edge_list]

    @property
    def edges(self) -> List[Tuple[Node, Node]]:
        return [(u, v) for u, v, _, _ in self._body_edges_full()]

    @property
    def edges_full(self) -> List[Tuple[Node, Node, int, Dict[str, Any]]]:
        """(source, destination, key, attributes) of each body edge, in the
        order of :attr:`edges`."""
        return self._body_edges_full()

    @property
    def edge_names(self) -> List[Tuple[str, str]]:
        return [(s.name, d.name) for s, d in self.edges]

    @property
    def edge_inds(self) -> List[Tuple[int, int]]:
        """Body edges as (source, destination) node-index pairs."""
        position = {id(n): i for i, n in enumerate(self._node_tuple)}
        return [(position[id(s)], position[id(d)]) for s, d in self.edges]

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def edge_to_index(self, source: Union[str, Node], destination: Union[str, Node]) -> int:
        edge = (self.find_node(source), self.find_node(destination))
        try:
            return self.edges.index(edge)
        except ValueError:
            return -1

    def has_edge(self, source_name: Union[str, Node], dest_name: Union[str, Node]) -> bool:
        src, dst = self.find_node(source_name), self.find_node(dest_name)
        if src is None or dst is None:
            return False
        keys = self._adj[src].get(dst, {})
        return any(a.get("type") == EdgeType.BODY for a in keys.values())

    def add_edge(self, source: Union[str, Node], destination: Union[str, Node]) -> None:
        source = source.name if isinstance(source, Node) else source
        destination = destination.name if isinstance(destination, Node) else destination
        src, dst = self.find_node(source), self.find_node(destination)
        if src is None:
            raise ValueError(f"Skeleton does not have source node named ({source}).")
        if dst is None:
            raise ValueError(f"Skeleton does not have destination node named ({destination}).")
        if self.has_edge(source, destination):
            raise ValueError(f"Skeleton already has an edge between ({source}) and ({destination}).")
        idx = self._num_edges_inserted
        self._num_edges_inserted = idx + 1
        self._add_graph_edge(src, dst, type=EdgeType.BODY, edge_insert_idx=idx)

    def add_edges(self, edges: Iterable[Tuple[str, str]]) -> None:
        for src, dst in edges:
            self.add_edge(src, dst)

    def delete_edge(self, source: Union[str, Node], destination: Union[str, Node]) -> None:
        source = source.name if isinstance(source, Node) else source
        destination = destination.name if isinstance(destination, Node) else destination
        if not self.has_edge(source, destination):
            raise ValueError(f"Skeleton has no edge between ({source}) and ({destination}).")
        src, dst = self.find_node(source), self.find_node(destination)
        for key, a in list(self._adj[src][dst].items()):
            if a.get("type") == EdgeType.BODY:
                self._remove_graph_edge(src, dst, key)

    def clear_edges(self) -> None:
        """Remove every body edge, keeping the nodes and symmetries."""
        for u, v, k, _ in self._body_edges_full():
            self._remove_graph_edge(u, v, k)

    def find_neighbors(self, node: Union[str, Node]) -> List[Node]:
        """Nodes joined to ``node`` by a body edge, either way."""
        node = self.find_node(node)
        if node is None:
            return []
        out: List[Node] = []
        for src, dst in self.edges:
            if src is node and dst not in out:
                out.append(dst)
            elif dst is node and src not in out:
                out.append(src)
        return out

    @property
    def root_nodes(self) -> List[Node]:
        """Nodes with no incoming body edge."""
        targets = {id(dst) for _, dst in self.edges}
        return [n for n in self._node_tuple if id(n) not in targets]

    # ------------------------------------------------------------------ #
    # Symmetries
    # ------------------------------------------------------------------ #
    @property
    def symmetries(self) -> List[Tuple[Node, Node]]:
        """Unique unordered symmetric pairs, in graph order."""
        seen, out = set(), []
        for u, v, _, a in self._graph_edges():
            if a.get("type") != EdgeType.SYMMETRY:
                continue
            key = frozenset((id(u), id(v)))
            if key not in seen:
                seen.add(key)
                out.append((u, v))
        return out

    @property
    def symmetry_names(self) -> List[Tuple[str, str]]:
        return [(a.name, b.name) for a, b in self.symmetries]

    @property
    def symmetric_inds(self) -> List[Tuple[int, int]]:
        position = {id(n): i for i, n in enumerate(self._node_tuple)}
        return [(position[id(a)], position[id(b)]) for a, b in self.symmetries]

    def flip_idx(self) -> List[int]:
        """Per-node index of the symmetric partner (itself where unpaired)."""
        idx = list(range(self.n_nodes))
        for a, b in self.symmetric_inds:
            idx[a], idx[b] = b, a
        return idx

    def get_symmetry(self, name: Union[str, Node]) -> Optional[Node]:
        node = name if isinstance(name, Node) else self.find_node(name)
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
        self._add_graph_edge(a, b, type=EdgeType.SYMMETRY)
        self._add_graph_edge(b, a, type=EdgeType.SYMMETRY)

    def delete_symmetry(self, node1: Union[str, Node], node2: Union[str, Node]) -> None:
        a = node1 if isinstance(node1, Node) else self.find_node(node1)
        b = node2 if isinstance(node2, Node) else self.find_node(node2)
        if (a, b) not in self.symmetries and (b, a) not in self.symmetries:
            raise ValueError("Nodes are not symmetric.")
        for u, v in ((a, b), (b, a)):
            for key, attrs in list(self._adj[u].get(v, {}).items()):
                if attrs.get("type") == EdgeType.SYMMETRY:
                    self._remove_graph_edge(u, v, key)

    # ------------------------------------------------------------------ #
    # Comparison
    # ------------------------------------------------------------------ #
    def matches(self, other: "Skeleton") -> bool:
        """Structural equality: the same node names, edges and symmetries."""
        return (
            set(self.node_names) == set(other.node_names)
            and set(map(tuple, self.edge_names)) == set(map(tuple, other.edge_names))
            and {frozenset(p) for p in self.symmetry_names}
            == {frozenset(p) for p in other.symmetry_names}
        )

    # ------------------------------------------------------------------ #
    # JSON
    # ------------------------------------------------------------------ #
    def to_dict(self, node_to_idx: Optional[Dict[Node, int]] = None) -> Dict[str, Any]:
        """A node-link dict: body edges, then each symmetry as two directed
        links, as the JAX package writes. Nodes are jsonpickle records, or
        with ``node_to_idx`` (node -> index) the integer indices of a
        ``.slp`` file's shared node list."""
        ids: Dict[int, int] = {}

        def encode(obj, first_form):
            if id(obj) in ids:
                return {"py/id": ids[id(obj)]}
            ids[id(obj)] = len(ids) + 1
            return first_form

        def node(n: Node):
            if node_to_idx is not None:
                return node_to_idx[n]
            return encode(n, {"py/object": "sleap.skeleton.Node",
                              "py/state": {"py/tuple": [n.name, n.weight]}})

        edge_types = {EdgeType.BODY: object(), EdgeType.SYMMETRY: object()}

        def edge_type(t: int):
            return encode(edge_types[t], {"py/reduce": [{"py/type": "sleap.skeleton.EdgeType"},
                                                        {"py/tuple": [t]}]})

        links = []
        for i, (src, dst) in enumerate(self.edges):
            links.append({"edge_insert_idx": i, "key": 0, "source": node(src),
                          "target": node(dst), "type": edge_type(EdgeType.BODY)})
        for src, dst in self.symmetries:
            for a, b in ((src, dst), (dst, src)):
                links.append({"key": 0, "source": node(a), "target": node(b),
                              "type": edge_type(EdgeType.SYMMETRY)})
        if node_to_idx is not None:
            nodes = [{"id": node_to_idx[n]} for n in self.nodes]
        else:
            nodes = [{"id": node(n)} for n in self.nodes]
        return {
            "directed": True,
            "graph": {"name": self.name, "num_edges_inserted": self._num_edges_inserted},
            "links": links,
            "multigraph": True,
            "nodes": nodes,
        }

    def to_json(self, node_to_idx: Optional[Dict[Node, int]] = None) -> str:
        return json.dumps(self.to_dict(node_to_idx))

    @classmethod
    def from_dict(cls, d: Dict[str, Any], node_list: Optional[List[Node]] = None) -> "Skeleton":
        """Decode a node-link dict whose nodes are jsonpickle records, or
        integer indices into ``node_list`` (the ``.slp`` style). Nodes keep
        their declared order; nodes only edges name follow, in order of
        appearance."""
        if "nx_graph" in d:  # template skeletons wrap the node-link dict
            d = d["nx_graph"]
        objects: List[Any] = []
        graph = d.get("graph", {})
        skel = cls(name=graph.get("name"))
        skel._num_edges_inserted = graph.get("num_edges_inserted", 0)
        links = []
        for link in d.get("links", []):
            src = _decode_node(link["source"], objects, node_list)
            dst = _decode_node(link["target"], objects, node_list)
            etype = _decode_edge_type(link["type"], objects)
            links.append((link.get("edge_insert_idx"), src, dst, etype))
        for nd in d.get("nodes", []):
            skel._add_graph_node(_decode_node(nd["id"], objects, node_list))
        seen_sym = set()
        for insert_idx, src, dst, etype in links:
            if etype == EdgeType.BODY:
                skel._add_graph_edge(src, dst, type=EdgeType.BODY, edge_insert_idx=insert_idx)
            else:
                key = frozenset((id(src), id(dst)))
                if key not in seen_sym:
                    seen_sym.add(key)
                    skel._add_graph_edge(src, dst, type=EdgeType.SYMMETRY)
                    skel._add_graph_edge(dst, src, type=EdgeType.SYMMETRY)
        return skel

    @classmethod
    def from_json(cls, json_str: str, node_list: Optional[List[Node]] = None) -> "Skeleton":
        return cls.from_dict(json.loads(json_str), node_list)

    def save_json(self, filename: str, node_to_idx: Optional[Dict[Node, int]] = None) -> None:
        with open(filename, "w") as f:
            f.write(self.to_json(node_to_idx))

    @classmethod
    def load_json(cls, filename: str, idx_to_node: Optional[Dict[int, Node]] = None) -> "Skeleton":
        node_list = [idx_to_node[i] for i in range(len(idx_to_node))] if idx_to_node else None
        with open(filename, "r") as f:
            return cls.from_json(f.read(), node_list)

    @classmethod
    def load_mat(cls, filename: str) -> "Skeleton":
        """A LEAP MATLAB skeleton: a ``nodeNames`` cell array and a 1-based
        ``edges`` matrix (read with scipy)."""
        import numpy as np
        from scipy.io import loadmat

        mat = loadmat(filename)
        node_names = [str(n[0][0]) for n in mat["nodeNames"]]
        skeleton = cls(name=filename)
        skeleton.add_nodes(node_names)
        for src, dst in np.asarray(mat["edges"]) - 1:
            skeleton.add_edge(node_names[int(src)], node_names[int(dst)])
        return skeleton

    @classmethod
    def from_names_and_edge_inds(cls, node_names: Sequence[str],
                                 edge_inds: Optional[Sequence[Tuple[int, int]]] = None,
                                 name: Optional[str] = None) -> "Skeleton":
        skel = cls(name=name)
        skel.add_nodes(node_names)
        for s, d in edge_inds or []:
            skel.add_edge(node_names[s], node_names[d])
        return skel


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


def load_template(name: str) -> Skeleton:
    """A template skeleton shipped in ``sleap_tpu_torch/skeletons/``
    (``bees``, ``flies13``, ``fly32``, ``gerbils``, ``mice_hc``,
    ``mice_of``)."""
    folder = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "skeletons")
    path = os.path.join(folder, f"{name}.json")
    if not os.path.exists(path):
        available = sorted(f[:-5] for f in os.listdir(folder) if f.endswith(".json"))
        raise FileNotFoundError(f"No template skeleton {name!r}; available: {available}")
    with open(path) as f:
        data = json.load(f)
    skel = Skeleton.from_dict(data["nx_graph"])
    skel.name = name
    return skel
