"""Graph API — the Gelly analog: the port of flink_tpu/gelly/graph.py (ref
flink-gelly Graph.java + the scatter-gather/`spargel`, gather-sum-apply/
`gsa`, and `pregel` iteration models, SURVEY §2.7) on an explicit device.

A graph IS columnar device state: vertex values [V] and an edge list
(src[E], dst[E], w[E]) as torch tensors on one device (the
``vertex_values``' device), and one superstep is

    gather:  msg[e]   = combine(value[src[e]], w[e])      (torch ops)
    sum:     agg[v]   = reduce msg over dst                 (G23)
    apply:   value[v] = update(value[v], agg[v])           (torch ops)

The Sum phase of every superstep, the degrees, PageRank's and HITS'
sums, the neighbourhood reduces and the dense adjacency are one launch of
G23 (``ops/cuda.py scatter_ids``) each; community detection's adopted
label is G25's arg-max mode (``row_argmax``). ``message_fn`` and
``update_fn`` are the user's functions and run as torch ops between the
gather and G23. The reference's ``lax.while_loop`` is a host loop here:
each superstep reads one change flag (one device sync), and the loop stops
after as many supersteps as the reference's, at most ``max_supersteps``;
its ``fori_loop`` is a plain loop. The dense metrics (triangles,
clustering, Jaccard, Adamic-Adar) multiply the dense adjacency with
itself in ``torch.matmul``, as the reference leaves that product to XLA.

``from_edge_list(..., device=None)`` and ``state_from_numpy(fields,
device=None)`` take the device: ``None`` means the CUDA card, and a
machine without one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.device import resolve_device
from flink_tpu_torch.ops import cuda as kernels


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _scatter(idx, vals, n: int, op: str) -> torch.Tensor:
    """One G23 launch: ``vals`` combined into n rows by ``idx``."""
    return kernels.scatter_ids(idx, vals.to(torch.float32).contiguous(), n,
                               op=op)[0]


def _degrees(idx, n: int) -> torch.Tensor:
    """int32 [n]: the lanes of each id (one G23 launch, counts only)."""
    return kernels.scatter_ids(idx, None, n, counts=True)[1]


@dataclass
class Graph:
    """Vertex ids are dense [0, V); use from_edge_list for arbitrary ids."""

    vertex_values: torch.Tensor       # [V] on the graph's device
    src: torch.Tensor                 # [E] int32
    dst: torch.Tensor                 # [E] int32
    edge_values: Optional[torch.Tensor] = None   # [E]
    ids: Optional[np.ndarray] = None  # [V] original vertex ids (host)

    # -- construction ----------------------------------------------------
    @staticmethod
    def from_edge_list(edges: List[Tuple[Any, Any]],
                       edge_values: Optional[List[float]] = None,
                       vertex_init: Optional[Callable[[Any], float]] = None,
                       undirected: bool = False, device=None) -> "Graph":
        dev = resolve_device(device)
        e = np.asarray([(a, b) for a, b in edges], dtype=object)
        ids, inv = np.unique(e.reshape(-1), return_inverse=True)
        src = inv[0::2].astype(np.int32)
        dst = inv[1::2].astype(np.int32)
        ev = (
            np.asarray(edge_values, np.float32)
            if edge_values is not None else None
        )
        if undirected:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if ev is not None:
                ev = np.concatenate([ev, ev])
        if vertex_init is None:
            values = np.arange(len(ids), dtype=np.float32)
        else:
            values = np.asarray([vertex_init(i) for i in ids], np.float32)
        return state_from_numpy({"vertex_values": values, "src": src,
                                 "dst": dst, "edge_values": ev, "ids": ids},
                                dev)

    @property
    def device(self) -> torch.device:
        return self.vertex_values.device

    @property
    def num_vertices(self) -> int:
        return int(self.vertex_values.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _ev(self) -> torch.Tensor:
        return (self.edge_values if self.edge_values is not None
                else torch.ones(self.num_edges, dtype=torch.float32,
                                device=self.device))

    def _resolve(self, v_idx) -> Dict[Any, Any]:
        """Device values -> {original_id: value} host dict."""
        vals = _host(v_idx)
        keys = self.ids if self.ids is not None else np.arange(len(vals))
        return dict(zip(keys.tolist(), vals.tolist()))

    # -- transforms (ref Graph.mapVertices/mapEdges/subgraph/reverse) -----
    def map_vertices(self, fn) -> "Graph":
        return Graph(fn(self.vertex_values), self.src, self.dst,
                     self.edge_values, self.ids)

    def map_edges(self, fn) -> "Graph":
        return Graph(self.vertex_values, self.src, self.dst, fn(self._ev()),
                     self.ids)

    def reverse(self) -> "Graph":
        return Graph(self.vertex_values, self.dst, self.src,
                     self.edge_values, self.ids)

    def filter_on_edges(self, pred) -> "Graph":
        """pred over (src_idx, dst_idx, edge_value) -> bool mask (host
        materialization; a structural change)."""
        ev = self._ev()
        keep = torch.as_tensor(_host(pred(self.src, self.dst, ev)),
                               device=self.device)
        return Graph(self.vertex_values, self.src[keep], self.dst[keep],
                     ev[keep], self.ids)

    def out_degrees(self) -> Dict[Any, int]:
        return self._resolve(_degrees(self.src, self.num_vertices))

    def in_degrees(self) -> Dict[Any, int]:
        return self._resolve(_degrees(self.dst, self.num_vertices))

    # -- scatter-gather iteration (the spargel/GSA/pregel contract) -------
    def scatter_gather(
        self,
        message_fn: Callable,         # (src_values_per_edge, edge_values) -> msgs [E]
        combine: str,                 # 'min' | 'sum' | 'max' (the Sum phase)
        update_fn: Callable,          # (old_values [V], agg [V], has_msg [V]) -> new [V]
        max_supersteps: int,
        neutral: float,
    ) -> "Graph":
        """Runs supersteps until no vertex value changes (the reference's
        'vertex did not update -> halts' convergence rule) or
        ``max_supersteps`` ran: a host loop that reads one change flag a
        superstep."""
        op = {"min": "min", "max": "max", "sum": "add"}.get(combine)
        if op is None:
            raise ValueError(combine)
        V = self.num_vertices
        src, dst = self.src.long(), self.dst
        ev = self._ev()

        def superstep(values):
            msgs = message_fn(values[src], ev)
            agg, _, has_msg = kernels.scatter_ids(
                dst, msgs.to(torch.float32).contiguous(), V, op=op,
                has=True)
            if float(neutral) != kernels.NEUTRAL[op]:    # NaN too
                agg = kernels.COMBINE[op](torch.full_like(agg, neutral), agg)
            return update_fn(values, agg.to(values.dtype), has_msg)

        values, prev, it = superstep(self.vertex_values), \
            self.vertex_values, 1
        while it < max_supersteps and bool((values != prev).any()):
            values, prev, it = superstep(values), values, it + 1
        return Graph(values, self.src, self.dst, self.edge_values, self.ids)

    # -- library algorithms (ref flink-gelly library/) --------------------
    def connected_components(self, max_supersteps: int = 64) -> Dict[Any, Any]:
        """ref GSAConnectedComponents: propagate min component id."""
        g = Graph(
            torch.arange(self.num_vertices, dtype=torch.float32,
                         device=self.device),
            self.src, self.dst, self.edge_values, self.ids,
        )
        out = g.scatter_gather(
            message_fn=lambda sv, ev: sv,
            combine="min",
            update_fn=lambda old, agg, has: torch.where(
                has & (agg < old), agg, old
            ),
            max_supersteps=max_supersteps,
            neutral=np.inf,
        )
        comp = _host(out.vertex_values).astype(int)
        if self.ids is not None:
            return {
                self.ids[i]: self.ids[c] for i, c in enumerate(comp.tolist())
            }
        return dict(enumerate(comp.tolist()))

    def page_rank(self, beta: float = 0.85,
                  num_iterations: int = 30) -> Dict[Any, float]:
        """ref PageRank library method: power iteration; dangling mass
        redistributed uniformly."""
        V = self.num_vertices
        out_deg = _degrees(self.src, V).to(torch.float32)
        src, dst = self.src.long(), self.dst
        deg_src = torch.clamp_min(out_deg[src], 1.0)
        dangling_v = out_deg == 0
        rank = torch.full((V,), 1.0 / V, dtype=torch.float32,
                          device=self.device)
        for _ in range(num_iterations):
            agg = _scatter(dst, rank[src] / deg_src, V, "add")
            dangling = torch.sum(torch.where(dangling_v, rank, 0.0))
            rank = (1 - beta) / V + beta * (agg + dangling / V)
        return self._resolve(rank)

    def single_source_shortest_paths(
        self, source: Any, max_supersteps: int = 64
    ) -> Dict[Any, float]:
        """ref SingleSourceShortestPaths: min-plus relaxation supersteps."""
        if self.ids is not None:
            src_idx = int(np.searchsorted(self.ids, source))
            if src_idx >= len(self.ids) or self.ids[src_idx] != source:
                raise KeyError(source)
        else:
            src_idx = int(source)
        dist0 = torch.full((self.num_vertices,), float("inf"),
                           dtype=torch.float32, device=self.device)
        dist0[src_idx] = 0.0
        g = Graph(dist0, self.src, self.dst, self.edge_values, self.ids)
        out = g.scatter_gather(
            message_fn=lambda sv, ev: sv + ev,
            combine="min",
            update_fn=lambda old, agg, has: kernels.fmin(old, agg),
            max_supersteps=max_supersteps,
            neutral=np.inf,
        )
        return self._resolve(out.vertex_values)

    def label_propagation(self, max_supersteps: int = 16) -> Dict[Any, Any]:
        """ref LabelPropagation (simplified: min-label consensus like CC but
        seeded with current vertex values as labels)."""
        out = self.scatter_gather(
            message_fn=lambda sv, ev: sv,
            combine="min",
            update_fn=lambda old, agg, has: torch.where(
                has, kernels.fmin(old, agg), old),
            max_supersteps=max_supersteps,
            neutral=np.inf,
        )
        vals = _host(out.vertex_values).astype(int)
        if self.ids is not None:
            return dict(zip(self.ids.tolist(), vals.tolist()))
        return dict(enumerate(vals.tolist()))

    def triangle_count(self) -> int:
        """ref TriangleEnumerator/Count: A ⊙ (A @ A) over the symmetric
        adjacency — a dense matmul for small/medium graphs."""
        A = _sym_adjacency(self)
        tri = torch.sum(A * (A @ A)) / 6.0
        return int(tri)

    def hits(self, num_iterations: int = 30) -> Dict[Any, Tuple[float, float]]:
        """ref HITSAlgorithm: hubs & authorities by power iteration —
        alternating sparse mat-vecs (two G23 launches an iteration) with
        L2 normalization."""
        V = self.num_vertices
        src, dst = self.src, self.dst
        h = torch.full((V,), 1.0 / np.sqrt(max(V, 1)), dtype=torch.float32,
                       device=self.device)
        a = h
        for _ in range(num_iterations):
            a = _scatter(dst, h[src.long()], V, "add")
            a = a / torch.clamp_min(torch.linalg.vector_norm(a), 1e-12)
            h = _scatter(src, a[dst.long()], V, "add")
            h = h / torch.clamp_min(torch.linalg.vector_norm(h), 1e-12)
        hubs = _host(h).tolist()
        auth = _host(a).tolist()
        keys = (self.ids if self.ids is not None
                else np.arange(V)).tolist()
        return {k: (hb, au) for k, hb, au in zip(keys, hubs, auth)}

    def community_detection(self, max_supersteps: int = 32,
                            delta: float = 0.5) -> Dict[Any, Any]:
        """ref CommunityDetection: label propagation with hop-attenuated
        label scores. Per-vertex (label, score); each superstep a vertex
        adopts the incoming label with the highest summed score, its own
        score decaying by delta per hop. The score mass per (receiver,
        label) is a dense [V, V] G23 sum over dst * V + label; the adopt
        and decay is G25's arg-max mode."""
        V = self.num_vertices
        src = self.src.long()
        dst_row = self.dst.long() * V
        labels = torch.arange(V, dtype=torch.float32, device=self.device)
        scores = torch.ones(V, dtype=torch.float32, device=self.device)
        prev = labels - 1
        it = 0
        while it < max_supersteps and bool((labels != prev).any()):
            idx = dst_row + labels[src].to(torch.int32).long()
            m = _scatter(idx, scores[src], V * V, "add").view(V, V)
            prev = labels
            labels, scores = kernels.row_argmax(m, labels, scores, delta)
            it += 1
        lab = _host(labels).astype(int)
        if self.ids is not None:
            return {self.ids[i]: self.ids[l]
                    for i, l in enumerate(lab.tolist())}
        return dict(enumerate(lab.tolist()))

    def jaccard_index(self) -> Dict[Tuple[Any, Any], float]:
        """ref JaccardIndex: |N(u) ∩ N(v)| / |N(u) ∪ N(v)| for every
        connected vertex pair — dense A@A over the symmetric adjacency,
        results for edges only."""
        V = self.num_vertices
        A = _sym_adjacency(self)
        common = A @ A                     # [V,V] shared-neighbor counts
        deg = torch.sum(A, 1)
        union = deg[:, None] + deg[None, :] - common
        jac = torch.where(union > 0,
                          common / torch.clamp_min(union, 1e-12), 0.0)
        s = _host(self.src)
        d = _host(self.dst)
        vals = _host(jac[self.src.long(), self.dst.long()])
        keys = self.ids if self.ids is not None else np.arange(V)
        out = {}
        for i in range(len(s)):
            a, b = keys[s[i]], keys[d[i]]
            if a != b:
                out[(a, b)] = float(vals[i])
        return out

    def summarize(self) -> "Graph":
        """ref Summarization: condense vertices with equal values into one
        super-vertex; parallel edges between groups collapse with summed
        edge values (edge dedup on the host: a structural change)."""
        vals = _host(self.vertex_values)
        groups, ginv = np.unique(vals, return_inverse=True)
        s = ginv[_host(self.src)]
        d = ginv[_host(self.dst)]
        ev = (_host(self.edge_values)
              if self.edge_values is not None
              else np.ones(len(s), np.float32))
        keep = s != d                       # intra-group edges vanish
        pair = s[keep].astype(np.int64) * len(groups) + d[keep]
        uniq_pair, pinv = np.unique(pair, return_inverse=True)
        agg = np.zeros(len(uniq_pair), np.float32)
        np.add.at(agg, pinv, ev[keep])
        return Graph(
            self._t(groups.astype(np.float32)),
            self._t((uniq_pair // len(groups)).astype(np.int32)),
            self._t((uniq_pair % len(groups)).astype(np.int32)),
            self._t(agg),
            None,
        )

    def union(self, other: "Graph") -> "Graph":
        """ref Graph.union: same vertex set (dense ids must agree), edge
        lists concatenate."""
        if self.num_vertices != other.num_vertices:
            raise ValueError("union requires identical vertex sets")
        return Graph(
            self.vertex_values,
            torch.cat([self.src, other.src]),
            torch.cat([self.dst, other.dst]),
            torch.cat([self._ev(), other._ev()]),
            self.ids,
        )

    def subgraph(self, vertex_pred, edge_pred=None) -> "Graph":
        """ref Graph.subgraph: keep edges whose endpoints satisfy
        vertex_pred (over vertex values) and the edge satisfies
        edge_pred."""
        vmask = _host(vertex_pred(self.vertex_values)).astype(bool)
        s = _host(self.src)
        d = _host(self.dst)
        ev = self._ev()
        keep = vmask[s] & vmask[d]
        if edge_pred is not None:
            keep &= _host(edge_pred(self.src, self.dst, ev)).astype(bool)
        ev = _host(ev)
        return Graph(
            self.vertex_values, self._t(s[keep].astype(np.int32)),
            self._t(d[keep].astype(np.int32)), self._t(ev[keep]), self.ids,
        )


def state_from_numpy(fields: Dict[str, Any], device=None) -> Graph:
    """A port Graph from host arrays named as the reference's ``Graph``
    fields: ``vertex_values`` [V], ``src`` / ``dst`` [E] (int32),
    optionally ``edge_values`` [E] and ``ids`` [V] (kept on the host).
    ``device``: ``None`` means the CUDA card."""
    dev = resolve_device(device)
    ev = fields.get("edge_values")
    ids = fields.get("ids")
    return Graph(
        torch.as_tensor(np.array(fields["vertex_values"]), device=dev),
        torch.as_tensor(np.array(fields["src"], np.int32), device=dev),
        torch.as_tensor(np.array(fields["dst"], np.int32), device=dev),
        (torch.as_tensor(np.array(ev, np.float32), device=dev)
         if ev is not None else None),
        np.asarray(ids) if ids is not None else None,
    )


# -- neighborhood reduces, clustering metrics, similarity, and graph
# -- mutations (ref flink-gelly Graph.java reduceOnEdges/reduceOnNeighbors,
# -- library/clustering + library/similarity, addVertex/removeVertex/
# -- addEdge/removeEdge)
def _neighbor_reduce(graph: "Graph", values_per_edge, combine: str):
    """Reduce per-edge values onto their DESTINATION vertex — one G23
    launch, the Sum half of GSA (shared by the methods below). The
    target starts at the combine's neutral (0, inf, -inf), as the
    reference's does."""
    op = {"sum": "add", "min": "min", "max": "max"}[combine]
    return _scatter(graph.dst, values_per_edge, graph.num_vertices, op)


def _drop_edgeless(orig: "Graph", g: "Graph", out) -> Dict[Any, float]:
    """The reference's reduceOnEdges/reduceOnNeighbors emit NO result for
    vertices without edges in the requested direction; the scatter
    neutral (inf/-inf/0) must not leak into the user-facing dict."""
    has = np.zeros(orig.num_vertices, bool)
    has[_host(g.dst)] = True
    full = orig._resolve(out)
    ids = (orig.ids if orig.ids is not None
           else np.arange(orig.num_vertices))
    return {k: v for k, v, h in zip(ids.tolist(), full.values(), has) if h}


def _ext_reduce_on_edges(self, combine: str = "sum",
                         direction: str = "in") -> Dict[Any, float]:
    """ref Graph.reduceOnEdges(EdgesFunction): per-vertex reduce of edge
    VALUES over its in-/out-/all edges."""
    ev = self._ev()
    if combine not in ("sum", "min", "max"):
        raise KeyError(combine)
    g = {"in": self, "out": self.reverse(),
         "all": None}.get(direction, "bad")
    if isinstance(g, str):
        raise ValueError("direction must be in|out|all")
    if g is None:
        both = Graph(self.vertex_values,
                     torch.cat([self.src, self.dst]),
                     torch.cat([self.dst, self.src]),
                     torch.cat([ev, ev]), self.ids)
        return both.reduce_on_edges(combine, "in")
    out = _neighbor_reduce(g, ev, combine)
    return _drop_edgeless(self, g, out)


def _ext_reduce_on_neighbors(self, combine: str = "sum",
                             direction: str = "in") -> Dict[Any, float]:
    """ref Graph.reduceOnNeighbors(ReduceNeighborsFunction): per-vertex
    reduce of NEIGHBOR vertex values."""
    if combine not in ("sum", "min", "max"):
        raise KeyError(combine)
    if direction == "all":
        both = Graph(self.vertex_values,
                     torch.cat([self.src, self.dst]),
                     torch.cat([self.dst, self.src]),
                     None, self.ids)
        return both.reduce_on_neighbors(combine, "in")
    g = {"in": self, "out": self.reverse()}.get(direction)
    if g is None:
        raise ValueError("direction must be in|out|all")
    vals = g.vertex_values[g.src.long()]
    out = _neighbor_reduce(g, vals, combine)
    return _drop_edgeless(self, g, out)


def _sym_adjacency(self) -> torch.Tensor:
    """Symmetric simple-graph adjacency [V, V] (duplicates collapse, self-
    loops masked) — the ONE recipe shared by every dense metric
    (triangle_count, jaccard_index, clustering coefficients, adamic_adar).
    The reference's ``zeros.at[src, dst].set(1.0)`` is G23's touched-row
    flag over src * V + dst: 1.0 exactly where an edge lands."""
    V = self.num_vertices
    idx = self.src.long() * V + self.dst.long()
    _, _, touched = kernels.scatter_ids(idx, None, V * V, has=True)
    A = touched.view(V, V).to(torch.float32)
    A = torch.maximum(A, A.T)
    return A * (1 - torch.eye(V, dtype=torch.float32, device=self.device))


def _ext_local_clustering_coefficient(self) -> Dict[Any, float]:
    """ref library/clustering LocalClusteringCoefficient: per vertex,
    2 * triangles(v) / (deg(v) * (deg(v) - 1)) over the undirected
    simple graph, through the dense adjacency matmul A @ A masked by A."""
    A = _sym_adjacency(self)
    paths2 = A @ A                      # [V, V] 2-paths between pairs
    tri_v = torch.sum(paths2 * A, 1) / 2.0   # triangles through v
    deg = torch.sum(A, 1)
    denom = deg * (deg - 1.0)
    coef = torch.where(denom > 0, 2.0 * tri_v / denom, 0.0)
    return self._resolve(coef)


def _ext_global_clustering_coefficient(self) -> float:
    """ref library/clustering GlobalClusteringCoefficient:
    3 * triangles / open-or-closed triplets."""
    A = _sym_adjacency(self)
    tri = float(torch.trace(A @ A @ A)) / 6.0
    deg = torch.sum(A, 1)
    triplets = float(torch.sum(deg * (deg - 1.0))) / 2.0
    return 3.0 * tri / triplets if triplets else 0.0


def _ext_adamic_adar(self) -> Dict[Tuple[Any, Any], float]:
    """ref library/similarity AdamicAdar: for vertex pairs sharing >= 1
    neighbor, sum of 1/log(deg(shared neighbor)) — one weighted
    adjacency matmul (A_w = A / log deg broadcast)."""
    V = self.num_vertices
    A = _sym_adjacency(self)
    deg = torch.sum(A, 1)
    w = torch.where(deg > 1, 1.0 / torch.log(torch.clamp_min(deg, 2.0)),
                    0.0)
    S = _host(A @ (A * w[:, None]))  # S[i,j] = sum_k A[i,k] w[k] A[k,j]
    ids = self.ids if self.ids is not None else np.arange(V)
    out = {}
    ii, jj = np.nonzero(np.triu(S, k=1) > 1e-9)
    adj = _host(A) > 0
    for i, j in zip(ii.tolist(), jj.tolist()):
        if not adj[i, j]:              # score only non-adjacent pairs
            out[(ids[i], ids[j])] = float(S[i, j])
    return out


def _ext_add_edges(self, edges, edge_values=None) -> "Graph":
    """ref Graph.addEdges: endpoints must already exist (unknown ids
    raise, matching the reference's semantics of ignoring invalid
    edges loudly rather than silently here)."""
    ids = self.ids if self.ids is not None else np.arange(self.num_vertices)
    index = {k: i for i, k in enumerate(ids.tolist())}
    try:
        s = np.asarray([index[a] for a, _b in edges], np.int32)
        d = np.asarray([index[b] for _a, b in edges], np.int32)
    except KeyError as e:
        raise ValueError(f"add_edges: unknown vertex {e.args[0]!r}; "
                         f"add_vertices first") from None
    ev = self.edge_values
    if ev is not None or edge_values is not None:
        old = (_host(ev) if ev is not None
               else np.ones(self.num_edges, np.float32))
        new = (np.asarray(edge_values, np.float32)
               if edge_values is not None
               else np.ones(len(edges), np.float32))
        ev = self._t(np.concatenate([old, new]))
    return Graph(
        self.vertex_values,
        torch.cat([self.src, self._t(s)]),
        torch.cat([self.dst, self._t(d)]),
        ev, self.ids,
    )


def _ext_add_vertices(self, new_ids, values=None) -> "Graph":
    ids = self.ids if self.ids is not None else np.arange(self.num_vertices)
    existing = set(ids.tolist())
    new_ids = list(new_ids)
    if values is not None and len(values) != len(new_ids):
        raise ValueError(
            f"add_vertices: {len(new_ids)} ids but {len(values)} values"
        )
    seen = set(existing)
    keep = []
    for j, i in enumerate(new_ids):
        if i not in seen:                # dedup within new_ids too
            seen.add(i)
            keep.append(j)
    fresh = [new_ids[j] for j in keep]
    if not fresh:
        return self
    # values selected BY POSITION OF THE SURVIVING IDS — a duplicate id
    # must not shift its neighbor's value onto the wrong vertex
    vals = (np.asarray(values, np.float32)[keep]
            if values is not None else np.zeros(len(fresh), np.float32))
    return Graph(
        torch.cat([self.vertex_values,
                   self._t(vals).to(self.vertex_values.dtype)]),
        self.src, self.dst, self.edge_values,
        np.concatenate([np.asarray(ids, object),
                        np.asarray(fresh, object)]),
    )


def _ext_remove_vertices(self, victim_ids) -> "Graph":
    """ref Graph.removeVertices: drops the vertices AND every incident
    edge, recompacting indices."""
    ids = self.ids if self.ids is not None else np.arange(self.num_vertices)
    victims = set(victim_ids)
    keep_mask = np.asarray([i not in victims for i in ids.tolist()])
    remap = np.cumsum(keep_mask) - 1
    s = _host(self.src)
    d = _host(self.dst)
    ekeep = keep_mask[s] & keep_mask[d]
    ev = self.edge_values
    return Graph(
        self._t(_host(self.vertex_values)[keep_mask]),
        self._t(remap[s[ekeep]].astype(np.int32)),
        self._t(remap[d[ekeep]].astype(np.int32)),
        self._t(_host(ev)[ekeep]) if ev is not None else None,
        np.asarray(ids, object)[keep_mask],
    )


def _ext_remove_edges(self, edges) -> "Graph":
    ids = self.ids if self.ids is not None else np.arange(self.num_vertices)
    index = {k: i for i, k in enumerate(ids.tolist())}
    drop = {(index.get(a, -1), index.get(b, -2)) for a, b in edges}
    s = _host(self.src)
    d = _host(self.dst)
    keep = np.asarray([
        (int(a), int(b)) not in drop for a, b in zip(s, d)
    ], bool)                             # explicit dtype: E == 0 edges
    ev = self.edge_values
    return Graph(
        self.vertex_values,
        self._t(s[keep]), self._t(d[keep]),
        self._t(_host(ev)[keep]) if ev is not None else None,
        self.ids,
    )


Graph.reduce_on_edges = _ext_reduce_on_edges
Graph.reduce_on_neighbors = _ext_reduce_on_neighbors
Graph.local_clustering_coefficient = _ext_local_clustering_coefficient
Graph.global_clustering_coefficient = _ext_global_clustering_coefficient
Graph.adamic_adar = _ext_adamic_adar
Graph.add_edges = _ext_add_edges
Graph.add_vertices = _ext_add_vertices
Graph.remove_vertices = _ext_remove_vertices
Graph.remove_edges = _ext_remove_edges
