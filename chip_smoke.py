#!/usr/bin/env python3
"""Smoke test of the aligner's device path on NVIDIA GPUs.

Run from the root of a checkout, on a machine with a card:

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # four cards: the sharded path only

One card, three phases in one process:

1. device check — the card's name and power limit (nvidia-smi), JAX's
   version and devices; anything but a GPU backend is a failure;
2. kernels at real widths — the compiled graph-DP fill, the S upload and
   shear and the code chase (``memory_analysis`` of each) on every level
   batch of a fam100 fixed-tree run, on 8 x ~2000-residue pairs and on the
   rep8 repeat pairs, compared with the numpy tier with zero tolerance:
   mappings, TR-indel counts and f32 scores equal, S equal bit for bit;
3. end to end through the CLI (``--engine pallas --timings``) — fam100
   fixed tree, fam100 free tree and rep8 byte-compared with their goldens,
   with every pair on the device, no ``fb_*`` fallback, and NW on the
   device in the free-tree run; the warm wall time of each case is
   printed.

``--four`` runs only the sharded path on a four-card mesh: fam500
``-T -i 0 --mldist --nwdist`` with NW sharded over the cards, compared
with ``--engine native`` in the same process, and the fam100 free tree
with each guide-tree level sharded over the cards, against its golden.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; a failed phase
exits non-zero without it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
GOLD = os.path.join(FIX, "golden")
OUT = os.path.join(HERE, "chiprun_out", "smoke")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def phase_device(n_cards: int):
    import jax

    print("jax", jax.__version__, jax.devices(), flush=True)
    dev = jax.devices()[0]
    check(dev.platform == "gpu", "JAX backend is %s, not a GPU"
          % dev.platform)
    check(len(jax.devices()) == n_cards, "expected %d cards, JAX sees %d"
          % (n_cards, len(jax.devices())))
    from prographmsa_tpu.runtime import enable_compile_cache
    print("compile cache:", enable_compile_cache(), flush=True)
    return dev


def _opts(args):
    from prographmsa_tpu.cli import build_parser, options_from_args
    return options_from_args(build_parser().parse_args(args))


def _level_batches(args):
    """The graph-DP batch of every guide-tree level of a CLI run (the
    batches are recorded while the host aligns them)."""
    from prographmsa_tpu.align import graph_dp_pallas as G
    from prographmsa_tpu.cli import do_align
    from prographmsa_tpu.io.fasta import read_fasta

    batches = []
    orig = G.align_pairs_device
    G.align_pairs_device = lambda items, **kw: (
        batches.append(list(items)) or [None] * len(items))
    try:
        opts = _opts(args + ["--engine", "pallas"])
        do_align(read_fasta(opts.sequence_file)[0], opts)
    finally:
        G.align_pairs_device = orig
    return batches, opts


def _long_batch():
    """8 pairs of ~2000-residue random proteins (seeded)."""
    import numpy as np

    from prographmsa_tpu.align.scores import DynProgScores
    from prographmsa_tpu.alphabet import AA_SPEC
    from prographmsa_tpu.graph.graph import sequence_graph
    from prographmsa_tpu.models.factory import get_default_model_factory

    rng = np.random.default_rng(11)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    encs = [(AA_SPEC.encode("".join(rng.choice(aas) for _ in range(2000))),
             AA_SPEC.encode("".join(rng.choice(aas) for _ in range(1980))))
            for _ in range(8)]
    opts = _opts(["--fasta", os.path.join(FIX, "fam6.fasta")])
    model = get_default_model_factory(
        opts, AA_SPEC, [e for p in encs for e in p]).get_model(0.7, opts,
                                                               0.7)
    items = []
    for e1, e2 in encs:
        g1, g2 = sequence_graph(AA_SPEC, e1), sequence_graph(AA_SPEC, e2)
        items.append((g1, g2, model, DynProgScores(g1, g2, model, opts)))
    return [items], opts


def _check_batch(name, k, batch, opts):
    import numpy as np

    from prographmsa_tpu.align import graph_dp_pallas as G
    from prographmsa_tpu.align.scores import precompute_scores
    from prographmsa_tpu.engine.progressive import align_graphs

    res = G.align_pairs_device(batch)
    numpy_opts = opts.replace(engine="numpy")
    for p, ((g1, g2, m, sc), r) in enumerate(zip(batch, res)):
        ref = align_graphs(g1, g2, m, numpy_opts, scores=sc)[0]
        where = "%s batch %d pair %d" % (name, k, p)
        check(r is not None, where + " left the device path")
        check(list(r[0]) == list(ref.mapping1)
              and list(r[1]) == list(ref.mapping2), where + ": mapping")
        check(np.float32(r[2]).tobytes() == np.float32(ref.score).tobytes(),
              where + ": score %r != %r" % (r[2], ref.score))
        check(r[3] == ref.n_tr_indels, where + ": n_tr_indels")

    # S as the fill reads it (host S, uploaded and sheared on the card)
    infos = [G._prep_pair(i, *it) for i, it in enumerate(batch)]
    B, n1p, n2s, DB, op, R = G._dims(infos)
    flat = infos + [None] * (B - len(infos))
    Sd = np.asarray(G._make_shear(DB)(G._host_s(flat, n1p, n2s)))
    for p, info in enumerate(infos):
        S = precompute_scores(info.g1, info.g2, info.model, info.scores,
                              engine="numpy").astype(np.float32)
        S = np.where(np.isnan(S) | (S < G.NEG), G.NEG, S)
        y, x = np.meshgrid(np.arange(info.n1), np.arange(info.n2),
                           indexing="ij")
        check(np.array_equal(Sd[p, y + x, y].view(np.uint32),
                             S.view(np.uint32)),
              "%s batch %d pair %d: S differs from the numpy tier"
              % (name, k, p))
    return B, n1p, n2s, DB, op, R


def _memory(batch_dims):
    import jax
    import jax.numpy as jnp

    from prographmsa_tpu.align import graph_dp_pallas as G

    B, n1p, n2s, DB, op, R = batch_dims
    f32, i32 = jnp.float32, jnp.int32
    S = jax.ShapeDtypeStruct
    fill_args = (S((B, 8), i32), S((B, 8), f32), S((B, op), i32),
                 S((B, op), i32), S((B, op, n1p), f32),
                 S((B, op, DB + n1p), f32), S((B, DB, n1p), f32))
    fill = G._make_fill(B, n1p, DB, op, R, False)
    outs = jax.eval_shape(fill, *fill_args)
    chase_args = (S((B, op), i32), S((B, op), i32), S((B, n1p, op), f32),
                  S((B, n2s, op), f32), S((B, n1p, op), i32),
                  S((B, n2s, op), i32), S((B, 8), f32), S((B,), i32),
                  S((B,), i32))
    for label, fn, args in (
            ("S shear", G._make_shear(DB), (S((B, n1p, n2s), f32),)),
            ("fill", fill, fill_args),
            ("chase", G._make_chase(), tuple(outs) + chase_args)):
        print("memory_analysis %-7s B=%d n1p=%d DB=%d op=%d R=%d: %s"
              % (label, B, n1p, DB, op, R,
                 fn.lower(*args).compile().memory_analysis()), flush=True)


def phase_kernels():
    from prographmsa_tpu.align import graph_dp_pallas as G

    sets = [
        ("fam100",) + _level_batches(
            ["--fasta", "-t", os.path.join(GOLD, "tree0_fam100.nwk"),
             os.path.join(FIX, "fam100.fasta")]),
        ("8x2000",) + _long_batch(),
        ("rep8",) + _level_batches(
            ["--fasta", "--read_repeats", os.path.join(FIX, "rep8.trd"),
             "-t", os.path.join(GOLD, "tree0_rep8.nwk"),
             os.path.join(FIX, "rep8.fasta")]),
    ]
    for name, batches, opts in sets:
        t0 = time.perf_counter()
        for k, batch in enumerate(batches):
            dims = _check_batch(name, k, batch, opts)
        print("kernels %-7s %3d batches, %4d pairs: fill, S and chase "
              "equal the numpy tier (%.1f s with the references)"
              % (name, len(batches), sum(map(len, batches)),
                 time.perf_counter() - t0), flush=True)
        if name == "8x2000":
            _memory(dims)
            prof = {}
            G.align_pairs_device(batches[0], profile=prof)
            print("8x2000 warm phases (s):",
                  {k: round(v, 4) for k, v in prof.items()}, flush=True)


def _cli(args, out):
    from prographmsa_tpu import cli, timings

    t0 = time.perf_counter()
    rc = cli.main(args + ["--timings", "-o", out])
    wall = time.perf_counter() - t0
    check(rc == 0, "CLI %s exited %d" % (" ".join(args), rc))
    return wall, timings.counters()


def _check_device_counters(label, c, nw):
    fb = {k: v for k, v in c.items() if "fb_" in k and v}
    check(not fb, "%s: host fallbacks %s" % (label, fb))
    total = c.get("pallas_pairs_total", 0)
    check(total > 0 and c.get("pallas_pairs_device", 0) == total,
          "%s: %s of %d pairs on the device"
          % (label, c.get("pallas_pairs_device", 0), total))
    if nw:
        check(c.get("nw_device_pairs", 0) > 0 and not c.get("route_nw_host"),
              "%s: NW did not run on the device" % label)


def _same(a, b):
    with open(a) as fa, open(b) as fb:
        return fa.read() == fb.read()


def phase_e2e(name):
    cases = [
        ("t_fam100.fasta", ["--fasta", "-t",
                            os.path.join(GOLD, "tree0_fam100.nwk"),
                            os.path.join(FIX, "fam100.fasta")], False),
        ("c2_fam100.fasta", ["--fasta", "--mldist", "--nwdist",
                             os.path.join(FIX, "fam100.fasta")], True),
        ("c5_rep8_t.fasta", ["--fasta", "--read_repeats",
                             os.path.join(FIX, "rep8.trd"), "-t",
                             os.path.join(GOLD, "tree0_rep8.nwk"),
                             os.path.join(FIX, "rep8.fasta")], False),
    ]
    for golden, args, nw in cases:
        out = os.path.join(OUT, golden)
        walls = []
        for _ in range(2):                  # the first run compiles
            wall, c = _cli(args + ["--engine", "pallas"], out)
            walls.append(wall)
            check(_same(out, os.path.join(GOLD, golden)),
                  "%s differs from its golden" % golden)
            _check_device_counters(golden, c, nw)
        print("e2e %-16s identical; first %.3f s, warm %.3f s (%s); "
              "%d pairs on the device"
              % (golden, walls[0], walls[1], name,
                 c["pallas_pairs_device"]), flush=True)


def phase_four(name, big="fam500", family="fam100"):
    from prographmsa_tpu.engine_policy import level_mesh

    mesh = level_mesh()
    check(mesh is not None and mesh.size == 4,
          "the level mesh does not span four cards")
    fam500 = ["-T", "-i", "0", "--mldist", "--nwdist",
              os.path.join(FIX, big + ".fasta")]
    walls = {}
    for eng in ("pallas", "native", "pallas"):
        out = os.path.join(OUT, "fam500_%s.nwk" % eng)
        walls[eng], c = _cli(fam500 + ["--engine", eng], out)
        if eng == "pallas":
            check(c.get("nw_sharded_chunks", 0) > 0,
                  "fam500: NW was not sharded over the cards")
    check(_same(os.path.join(OUT, "fam500_pallas.nwk"),
                os.path.join(OUT, "fam500_native.nwk")),
          "fam500 tree on four cards differs from --engine native")
    print("four %s -T -i 0 --mldist --nwdist: tree identical to "
          "--engine native; warm %.3f s sharded vs %.3f s native (%s)"
          % (big, walls["pallas"], walls["native"], name), flush=True)

    golden = "c2_%s.fasta" % family
    out = os.path.join(OUT, "four_" + golden)
    args = ["--fasta", "--mldist", "--nwdist", "--engine", "pallas",
            os.path.join(FIX, family + ".fasta")]
    for _ in range(2):
        wall, c = _cli(args, out)
        check(_same(out, os.path.join(GOLD, golden)),
              "%s on four cards differs from its golden" % golden)
        _check_device_counters(golden + " (four cards)", c, True)
        check(c.get("dp_sharded_levels", 0) > 0,
              "%s: no level was sharded over the cards" % golden)
    print("four %s: identical; warm %.3f s, %d levels sharded (%s)"
          % (golden, wall, c["dp_sharded_levels"], name), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    a = ap.parse_args()
    if not a.four:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    sys.path.insert(0, HERE)
    name = card()
    print(name, flush=True)
    try:
        dev = phase_device(4 if a.four else 1)
        os.makedirs(OUT, exist_ok=True)
        if a.four:
            phase_four(name)
        else:
            phase_kernels()
            phase_e2e(name)
    except Exception as e:  # noqa: BLE001 — any failure fails the smoke
        import traceback
        traceback.print_exc()
        print("FAILED: %r" % (e,), file=sys.stderr)
        return 1
    import jax
    print(name, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
