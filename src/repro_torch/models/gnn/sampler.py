"""Layer-wise neighbor sampler (GraphSAGE-style) for ``minibatch_lg``, a
numpy copy of ``repro/models/gnn/sampler.py`` (host code, no torch): the
same draws from the same ``RandomState`` give the same arrays.

Over a CSR adjacency; emits *static-shape* padded batches so a step's
shapes never change:

- seeds: (batch_nodes,) target nodes
- hop h with fanout f_h: every frontier node draws f_h neighbors with
  replacement (degree-0 nodes self-loop), giving a fixed edge count
  n_frontier * f_h per hop.
- all sampled nodes are compacted into a local index space; edges are
  (src_local, dst_local) arrays; a mask marks padding.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (E,)
    n_nodes: int

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr, src.astype(np.int64), n_nodes)

    def degree(self, v):
        return self.indptr[v + 1] - self.indptr[v]


def random_powerlaw_graph(n_nodes: int, avg_degree: int,
                          seed: int = 0) -> CSRGraph:
    """Synthetic power-law-ish graph (preferential-attachment flavor)."""
    rng = np.random.RandomState(seed)
    n_edges = n_nodes * avg_degree
    # degree-biased endpoints via Zipf-weighted sampling
    w = 1.0 / np.arange(1, n_nodes + 1) ** 0.75
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w)
    dst = rng.randint(0, n_nodes, size=n_edges)
    return CSRGraph.from_edges(src, dst, n_nodes)


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                    rng: np.random.RandomState) -> dict:
    """Returns local-index arrays: nodes (global ids), src, dst, edge_mask."""
    frontier = seeds.astype(np.int64)
    all_nodes = [frontier]
    edges_src, edges_dst = [], []
    for f in fanouts:
        deg = g.degree(frontier)
        # sample f neighbors w/ replacement; degree-0 -> self loop
        offs = rng.randint(0, np.maximum(deg, 1)[:, None],
                           size=(len(frontier), f))
        nbr = g.indices[np.minimum(g.indptr[frontier][:, None] + offs,
                                   len(g.indices) - 1)]
        self_loop = deg == 0
        nbr[self_loop] = frontier[self_loop][:, None]
        edges_src.append(nbr.reshape(-1))
        edges_dst.append(np.repeat(frontier, f))
        frontier = np.unique(nbr.reshape(-1))
        all_nodes.append(frontier)

    nodes, local = np.unique(np.concatenate(all_nodes), return_inverse=False), None
    lut = {int(v): i for i, v in enumerate(nodes)}
    map_f = np.vectorize(lut.__getitem__, otypes=[np.int64])
    src = map_f(np.concatenate(edges_src))
    dst = map_f(np.concatenate(edges_dst))
    return {
        "nodes": nodes,
        "src": src,
        "dst": dst,
        "seeds_local": map_f(seeds.astype(np.int64)),
    }


def static_sample(g: CSRGraph, seeds: np.ndarray, fanouts: list[int],
                  rng: np.random.RandomState) -> dict:
    """Fully static-shape sampler (TPU-friendly: the jitted step never
    recompiles). No dedup — the sampled tree is materialized node-by-node,
    so node/edge counts are exact functions of (batch_nodes, fanouts):

        nodes = b * (1 + f0 + f0*f1 + ...);  edges = b * (f0 + f0*f1 + ...)

    Messages flow child -> parent (neighbor -> frontier node).
    """
    seeds = seeds.astype(np.int64)
    b = len(seeds)
    nodes = [seeds]
    src_l, dst_l = [], []
    frontier = seeds
    frontier_idx = np.arange(b, dtype=np.int64)
    next_off = b
    for f in fanouts:
        deg = g.degree(frontier)
        offs = (rng.randint(0, 1 << 30, size=(len(frontier), f))
                % np.maximum(deg, 1)[:, None])
        nbr = g.indices[np.minimum(g.indptr[frontier][:, None] + offs,
                                   max(len(g.indices) - 1, 0))]
        self_loop = deg == 0
        nbr[self_loop] = frontier[self_loop][:, None]
        new_nodes = nbr.reshape(-1)
        new_idx = next_off + np.arange(len(new_nodes), dtype=np.int64)
        src_l.append(new_idx)
        dst_l.append(np.repeat(frontier_idx, f))
        nodes.append(new_nodes)
        frontier, frontier_idx = new_nodes, new_idx
        next_off += len(new_nodes)
    return {
        "nodes": np.concatenate(nodes),
        "src": np.concatenate(src_l),
        "dst": np.concatenate(dst_l),
        "seeds_local": np.arange(b, dtype=np.int64),
    }


def static_node_count(batch_nodes: int, fanouts: list[int]) -> int:
    frontier, total = batch_nodes, batch_nodes
    for f in fanouts:
        frontier *= f
        total += frontier
    return total


def static_edge_count(batch_nodes: int, fanouts: list[int]) -> int:
    frontier, total = batch_nodes, 0
    for f in fanouts:
        total += frontier * f
        frontier *= f
    return total
