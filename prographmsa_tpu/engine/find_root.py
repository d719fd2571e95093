"""Root search (-r exhaustive / -rr greedy hill-climb).

Re-derivation of /root/reference/src/FindRoot.{h,cpp}: the rooted guide tree
becomes an unrooted node/edge graph; every candidate root edge yields a full
progressive alignment assembled from per-node *directional* caches (each
internal node caches up to 3 subtree alignments, one per incident edge,
FindRoot.h:93-133), so successive roots only recompute alignments not shared
with already-evaluated roots.  The best root minimizes gap parsimony.

Parity quirks reproduced on purpose:
* FindRoot.cpp declares an AA specialization of tree2graph (with CS-profile
  leaf handling and *without* copying branch support) — but tree2graph is a
  ``static`` function template in the header, so that specialization lives
  only in FindRoot.cpp's own translation unit and is DEAD CODE: main.cpp
  instantiates the generic template (verified against an instrumented
  from-source build: supports are real values, and the shipped binary's
  -r output matches the generic path byte-for-byte).  Hence: supports are
  always copied, and CS profiles are IGNORED for find-root leaves
  (FindRoot.h:173 ``(void)csprofile``).
* Leaf results carry no ``profiles`` entries (unlike progressive_alignment
  leaves, ProgressiveAlignment.h:73).
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
from ..errors import ParityError

from .gap_parsimony import score_alignment
from .progressive import (ProgressiveAlignmentResult,
                          align_progressive_results, sequence_graph)


class Node:
    __slots__ = ("edges", "cached", "name")

    def __init__(self):
        self.edges: List = [None, None, None]
        self.cached: List = [None, None, None]
        self.name = ""

    def is_leaf(self) -> bool:
        return self.edges[1] is None

    def get_alignment(self, e, factory, options, spec):
        """FindRoot::node::getAlignment (FindRoot.h:93-133)."""
        index = next(i for i in range(3) if self.edges[i] is e)
        if self.cached[index] is None:
            assert not self.is_leaf()
            index1, index2 = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[index]
            e1 = self.edges[index1]
            e2 = self.edges[index2]
            n1 = e1.other(self)
            n2 = e2.other(self)
            r1 = n1.get_alignment(e1, factory, options, spec)
            r2 = n2.get_alignment(e2, factory, options, spec)
            self.cached[index] = align_progressive_results(
                r1, r2, e1.length, e2.length, e1.support, e2.support,
                factory, options, spec)
        return self.cached[index]


class Edge:
    __slots__ = ("alignment", "nodes", "length", "support")

    def __init__(self):
        self.alignment = None
        self.nodes: List = [None, None]
        self.length = -1.0
        self.support = -1.0

    def other(self, n: Node) -> Node:
        return self.nodes[1] if self.nodes[0] is n else self.nodes[0]

    def get_alignment(self, factory, options, spec):
        """FindRoot::edge::getAlignment (FindRoot.h:136-147): the root
        splits this edge's length 50/50."""
        if self.alignment is None:
            r1 = self.nodes[0].get_alignment(self, factory, options, spec)
            r2 = self.nodes[1].get_alignment(self, factory, options, spec)
            self.alignment = align_progressive_results(
                r1, r2, self.length / 2, self.length / 2, self.support,
                self.support, factory, options, spec)
        return self.alignment


def _leaf_result(spec, name, tree_bl, sequences, repeats, csprofile,
                 factory, options) -> ProgressiveAlignmentResult:
    """Leaf setup (FindRoot.h:175-196; the generic template ignores
    csprofile — see module docstring)."""
    del tree_bl, csprofile
    if name not in sequences:
        raise ParityError("unknown sequence name: %s" % name)
    seq = sequences[name]
    res = ProgressiveAlignmentResult()
    res.is_csprofile = False
    res.graph = sequence_graph(spec, seq)

    if name in repeats:
        for rep in repeats[name]:
            tr_hom = np.full(res.graph.size, -1, dtype=np.int64)
            tr_hom[rep.start + 1:rep.start + 1 + len(rep.tr_hom)] = \
                rep.tr_hom
            res.tr_homologies.append(tr_hom)
            res.tr_source.append(name)
        res.graph.add_repeats(res.tr_homologies)

    res.aligned_sequences[name] = seq
    res.score = 0.0
    res.n_tr_indels = 0
    return res


def _tree2graph(spec, current: Node, tree, nodes, edges, sequences, repeats,
                csprofile, factory, options):
    """FindRoot::tree2graph (FindRoot.h:170-231; AA spec. FindRoot.cpp)."""
    current.name = tree.name
    if tree.is_leaf():
        current.cached[0] = _leaf_result(spec, current.name,
                                         tree.branch_length, sequences,
                                         repeats, csprofile, factory,
                                         options)
        return
    assert tree.n_children() == 2
    for slot, child in ((1, tree[0]), (2, tree[1])):
        e = Edge()
        edges.append(e)
        e.length = child.branch_length
        e.support = child.branch_support
        current.edges[slot] = e
        n = Node()
        nodes.append(n)
        n.edges[0] = e
        e.nodes[0] = current
        e.nodes[1] = n
        _tree2graph(spec, n, child, nodes, edges, sequences, repeats,
                    csprofile, factory, options)


def progressive_alignment_find_root(spec, sequences, tree, repeats,
                                    csprofile, factory, options
                                    ) -> ProgressiveAlignmentResult:
    """FindRoot.h:234-337."""
    nodes: List[Node] = []
    edges: List[Edge] = []

    if tree.n_children() == 2:
        e0 = Edge()
        edges.append(e0)
        e0.length = tree[0].branch_length + tree[1].branch_length
        e0.support = max(tree[0].branch_support, tree[1].branch_support)
        n0 = Node()
        nodes.append(n0)
        n0.edges[0] = e0
        e0.nodes[0] = n0
        n1 = Node()
        nodes.append(n1)
        n1.edges[0] = e0
        e0.nodes[1] = n1
        _tree2graph(spec, n0, tree[0], nodes, edges, sequences, repeats,
                    csprofile, factory, options)
        _tree2graph(spec, n1, tree[1], nodes, edges, sequences, repeats,
                    csprofile, factory, options)
    elif tree.n_children() == 3:
        n0 = Node()
        nodes.append(n0)
        for i in range(3):
            ei = Edge()
            edges.append(ei)
            ei.length = tree[i].branch_length
            ei.support = tree[i].branch_support
            ni = Node()
            nodes.append(ni)
            ni.edges[0] = ei
            ei.nodes[0] = n0
            ei.nodes[1] = ni
            n0.edges[i] = ei
            _tree2graph(spec, ni, tree[i], nodes, edges, sequences, repeats,
                        csprofile, factory, options)
    else:
        raise ParityError("multifurcations not allowed")

    gap_code = spec.gap_code
    if options.reroot_flag == 1:
        # -r evaluates EVERY edge, so every directional subtree alignment
        # will be needed: compute them wave-by-wave with independent
        # alignments of a wave sharded across host cores (
        # the reference walks them strictly sequentially,
        # FindRoot.h:234-337).  Each task is a pure function writing its
        # own cache slot, so results equal the sequential order's.
        _precompute_all_directional(nodes, edges, factory, options, spec)

    best_result = edges[0].get_alignment(factory, options, spec)
    best_score = score_alignment(best_result, edges[0], gap_code)

    if options.reroot_flag == 1:
        for e in edges[1:]:
            result = e.get_alignment(factory, options, spec)
            score = score_alignment(result, e, gap_code)
            if score < best_score:
                best_result = result
                best_score = score
    else:
        # heuristic: hill-climb over edges adjacent to the current best
        # (FindRoot.h:291-320)
        best_node = None
        best_edge = edges[0]
        while True:
            old_edge = best_edge
            old_node = best_node
            for i in range(2):
                n = old_edge.nodes[i]
                if n is old_node:
                    continue
                for j in range(3):
                    e = n.edges[j]
                    if e is old_edge or e is None:
                        continue
                    result = e.get_alignment(factory, options, spec)
                    score = score_alignment(result, e, gap_code)
                    if score < best_score:
                        best_result = result
                        best_edge = e
                        best_score = score
                        best_node = n
            if best_edge is old_edge:
                break

    print("best gap parsimony score: %s" % _fmt_score(best_score),
          file=sys.stderr)
    return best_result


def _fmt_score(score: int) -> str:
    # the reference streams a double; integral values print bare
    return "%g" % float(score)


_DIR_OTHERS = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _precompute_all_directional(nodes, edges, factory, options, spec):
    """Fill every node's directional cache and every edge's root alignment
    wave-by-wave: a wave = all uncomputed entries whose two inputs are
    already cached; its members are independent and run on a thread pool
    (the native align/merge kernels drop the GIL).  After this, the
    selection loop is pure cache hits."""
    from concurrent.futures import ThreadPoolExecutor

    from .. import native
    from .. import timings

    nt = native.n_threads()
    pool = ThreadPoolExecutor(max_workers=nt) if nt > 1 else None
    if pool is not None:
        native.lib()   # build/load once before the pool races on it

    def dir_ready(n, e):
        idx = next(i for i in range(3) if n.edges[i] is e)
        return n.cached[idx] is not None

    pending = []
    for n in nodes:
        if n.is_leaf():
            continue
        for i in range(3):
            if n.edges[i] is not None and n.cached[i] is None:
                pending.append((n, i))

    def deps(n, i):
        i1, i2 = _DIR_OTHERS[i]
        e1, e2 = n.edges[i1], n.edges[i2]
        return (e1.other(n), e1), (e2.other(n), e2)

    def run_shard(tasks):
        for n, i in tasks:
            with timings.phase("findroot_align"):
                n.get_alignment(n.edges[i], factory, options, spec)

    while pending:
        wave = [(n, i) for (n, i) in pending
                if all(dir_ready(dn, de) for dn, de in deps(n, i))]
        if not wave:
            raise ParityError("find-root wave scheduling stuck")
        if pool is not None and len(wave) > 1:
            shards = [wave[s::nt] for s in range(nt)]
            list(pool.map(run_shard, shards))
        else:
            run_shard(wave)
        done = set(map(tuple, wave))
        pending = [t for t in pending if tuple(t) not in done]

    # root alignments per edge (both directions now cached)
    def run_edges(es):
        for e in es:
            with timings.phase("findroot_align"):
                e.get_alignment(factory, options, spec)

    if pool is not None and len(edges) > 1:
        shards = [edges[s::nt] for s in range(nt)]
        list(pool.map(run_edges, shards))
    else:
        run_edges(edges)
    if pool is not None:
        pool.shutdown(wait=False)
