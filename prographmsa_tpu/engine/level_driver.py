"""Level-synchronous progressive alignment for the device engines.

The reference's per-node recursion (/root/reference/src/ProgressiveAlignment.h:92-93)
serializes every internal node.  Independent nodes of the guide tree — all
nodes whose children are complete — can align in the SAME batched kernel
launch (SURVEY §7 "orchestration"): per level this driver

  1. prepares every ready node on the host (models / expm, graph cleaning),
  2. launches ONE fused device batch (align/graph_dp_pallas.py) for all the
     level's pairs and fetches all mappings in ONE transfer,
  3. merges each node on the host (graph surgery is irregular index work),
     which unblocks the next level.

Pairs the device path does not take (size, offset or ring caps, more
repeat events than the chase records) rerun on the host engines, counted
under --timings, so output equals the sequential driver byte-for-byte —
asserted by tests/test_level_driver.py.

Not used when early refinement is enabled (its incremental re-alignment
consumes nodes in recursion order).  Under --repeats (round 5) the driver
IS used: the per-node TR stderr lines are buffered and re-emitted in the
reference's post-order after the alignment pass (nodes are collected in
post-order, so the emission loop just walks the node list), and repeat
backtrack steps stay on the device via the chase's markAlternativePath
event splice (align/graph_dp_pallas.py).
"""

from __future__ import annotations

from .. import timings
from ..errors import ParityError
from .progressive import (prealign_node, align_progressive_results,
                          progressive_alignment)


def _collect_nodes(tree):
    """Post-order node list with child indices."""
    nodes = []

    def rec(t):
        if t.is_leaf():
            nodes.append((t, None, None))
            return len(nodes) - 1
        if t.n_children() != 2:
            raise ParityError("only bifurcating trees allowed")
        c0 = rec(t[0])
        c1 = rec(t[1])
        nodes.append((t, c0, c1))
        return len(nodes) - 1

    rec(tree)
    return nodes


def progressive_alignment_batched(spec, sequences, tree, repeats, csprofile,
                                  factory, options):
    """Level-batched progressive_alignment (same result, device-batched
    alignment stage).  Falls back to the sequential driver when a feature
    requires recursion order."""
    if options.earlyref_flag:
        return progressive_alignment(spec, sequences, tree, repeats,
                                     csprofile, factory, options)

    from concurrent.futures import ThreadPoolExecutor

    from .. import native
    from ..engine_policy import use_pallas_dp
    from .progressive import align_graphs

    nodes = _collect_nodes(tree)
    results = [None] * len(nodes)
    nt = native.n_threads()
    pool = ThreadPoolExecutor(max_workers=nt) if nt > 1 else None
    if pool is not None:
        native.lib()  # build/load once before the pool races on it

    # leaves (ProgressiveAlignment.h:59-87 / .cpp:12-28)
    for i, (t, c0, c1) in enumerate(nodes):
        if c0 is not None:
            continue
        results[i] = progressive_alignment(spec, sequences, t, repeats,
                                           csprofile, factory, options)

    pending = [i for i, (t, c0, c1) in enumerate(nodes) if c0 is not None]
    tr_counts = {}
    while pending:
        ready = [i for i in pending
                 if results[nodes[i][1]] is not None
                 and results[nodes[i][2]] is not None]
        if not ready:
            raise ParityError("tree level scheduling stuck")

        # host prep for the whole level
        preps = {}
        items = []
        for i in ready:
            t, c0, c1 = nodes[i]
            r1, r2 = results[c0], results[c1]
            pre = prealign_node(r1, r2, t[0].branch_length,
                                t[1].branch_length, factory, options)
            preps[i] = pre
            model, _m1, _m2, cg1, _o1, cg2, _o2 = pre
            from ..align.scores import DynProgScores
            items.append((cg1, cg2, model, DynProgScores(cg1, cg2, model,
                                                         options)))

        # alignment stage for the whole level: one batched device launch +
        # one fetch on the device tier, otherwise the native host kernels
        # — threaded across the level's independent pairs (ctypes releases
        # the GIL, so the C++ fill / scores / backtrack of different pairs
        # run on separate cores; results are pure functions of the inputs,
        # so identical to the sequential order)
        batch = [None] * len(items)
        if use_pallas_dp(options):
            from ..align.graph_dp_pallas import (align_pairs_device,
                                                fallback_stats)
            from ..engine_policy import level_mesh
            mesh = level_mesh()
            if mesh is not None:
                timings.count("dp_sharded_levels")
            with timings.phase("dp_device"):
                before = fallback_stats()
                batch = align_pairs_device(items, mesh=mesh)
                after = fallback_stats()
            for k, v in after.items():
                if v > before.get(k, 0):   # surface silent fallbacks
                    timings.count("pallas_" + k, v - before.get(k, 0))

        # per-pair align (host fallback) + merge, both pure functions of the
        # node's own inputs — sharded across cores for the whole level
        alns = [None] * len(ready)
        for k, res in enumerate(batch):
            if res is not None:
                from ..align.backtrack import AlignmentResult
                m1, m2, score, ntr = res
                alns[k] = AlignmentResult(score=score, n_tr_indels=ntr,
                                          mapping1=m1, mapping2=m2)

        # align + merge + extend of independent nodes, sharded across
        # cores as ONE fused per-node task: the align stage is C-kernel
        # heavy (ctypes releases the GIL), and the merge/extend stage's
        # heavy parts (unify/merge_edges/pad_edges native kernels, numpy
        # extension) also drop the GIL — fusing them lets one core merge
        # node A while the other still aligns node B.  Every per-node
        # result is a pure function of that node's own inputs, so the
        # outcome is identical to the sequential order (results[] writes
        # go to distinct indices).
        # a pair the device batch left (counted there) aligns on the host
        host_opts = (options.replace(engine="native")
                     if options.engine == "pallas" else options)

        def _finish_shard(ks):
            for k in ks:
                i = ready[k]
                aln = alns[k]
                if aln is None:
                    cg1, cg2 = items[k][0], items[k][1]
                    aln = align_graphs(cg1, cg2, items[k][2], host_opts,
                                       scores=items[k][3])[0]
                t, c0, c1 = nodes[i]
                tr_counts[i] = aln.n_tr_indels
                results[i] = align_progressive_results(
                    results[c0], results[c1], t[0].branch_length,
                    t[1].branch_length, t[0].branch_support,
                    t[1].branch_support, factory, options, spec,
                    prealigned=preps[i], aln=aln, tr_print=False)

        if pool is not None and len(ready) > 1:
            # one coarse task per worker: task-dispatch overhead on a
            # 2-core host would otherwise eat the concurrency win
            shards = [list(range(len(ready)))[s::nt] for s in range(nt)]
            list(pool.map(_finish_shard, shards))
        else:
            _finish_shard(range(len(ready)))

        done = set(ready)
        pending = [i for i in pending if i not in done]

    if pool is not None:
        pool.shutdown(wait=False)

    if options.repeats_flag:
        # re-emit the per-node TR lines in the reference's post-order
        # (ProgressiveAlignment.h:470-473; ``nodes`` IS post-order, and
        # align_progressive_results was called with tr_print=False)
        import sys

        from .progressive import create_ancestral_seq_name
        for i, (t, c0, c1) in enumerate(nodes):
            if c0 is None:
                continue
            print("TR indels at %s: %d"
                  % (create_ancestral_seq_name(results[i].aligned_sequences),
                     tr_counts[i]), file=sys.stderr)
    return results[-1]
