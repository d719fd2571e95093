"""Run configuration for ProGraphMSA-JAX.

Mirrors every CLI flag of the reference binary 1:1 (reference:
/root/reference/src/main.h:37-82 `cmdlineopts_t` and src/main.cpp:37-246
for defaults and derived-default logic), but as a frozen dataclass that is
threaded explicitly through the pipeline instead of a global mutable struct.
Being hashable/frozen, it can be used as a jit-static argument.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Options:
    # --- file options (host-side only) ---
    output_file: str = ""
    sequence_file: str = ""
    tree_file: str = ""
    topo_file: str = ""
    cs_file: str = ""
    cmodel_file: str = ""
    readreps_file: str = ""
    trdout_file: str = ""
    profile_file: str = ""
    customtr_cmd: str = ""

    # --- mode flags ---
    iters: int = 2                      # main.cpp:159 -i/--iterations
    reroot_flag: int = 0                # main.cpp:117 -r (count; 2 = heuristic)
    wlsrefine_flag: int = 0             # main.cpp:120 -W (count; 2 = quintets)
    earlyref_flag: bool = False         # main.cpp:123 --early_refinement
    repeats_flag: int = 0               # main.cpp:105 -R/--repeats (count)
    repalign_flag: bool = False         # main.cpp:102 --repalign
    fasta_flag: bool = False            # main.cpp:60 -f/--fasta
    noforcealign_flag: bool = False     # main.cpp:93 -A/--no_force_align
    aafreqs_flag: bool = False          # main.cpp:138 -F/--estimate_aafreqs
    darwin_flag: bool = False           # main.cpp:129 -w/--darwin
    nwdist_flag: bool = False           # main.cpp:144 -a/--nwdist
    onlytree_flag: bool = False         # main.cpp:156 -T/--only_tree
    mldist_flag: bool = False           # main.cpp:147 -m/--mldist
    mldist_gap_flag: bool = False       # main.cpp:150 -M/--mldist_gap
    alltrees_flag: bool = False         # main.cpp:162 --all_trees
    ancestral_flag: bool = False        # main.cpp:165 --ancestral_seqs
    codon_flag: bool = False            # main.cpp:51 --codon
    dna_flag: bool = False              # main.cpp:56 --dna
    inputorder_flag: bool = False       # main.cpp:153 -I/--input_order

    # --- model parameters (defaults: main.cpp:63-160) ---
    indel_rate: float = 0.0093359375
    end_indel_prob: float = 0.12
    gapext_prob: float = 0.6119140625
    edge_halflife: float = 0.3
    altsplice_prob: float = 0.328125
    pseudo_count: float = 1000.0
    cutoff_dist: float = 2.2
    repeat_rate: float = 0.1            # --repeat_indel_rate
    repeatext_prob: float = 0.3         # --repeat_indel_ext
    max_dist: float = 2.2
    min_dist: float = 0.05
    max_pdist: float = 0.8
    min_pdist: float = 0.05

    # --- execution engine (extension; not a reference flag) ---
    # "auto": native C++ host kernels when available, numpy otherwise;
    # "native"/"numpy": force those; "device": per-node JAX DP kernels.
    # All engines produce bit-identical output (tests/test_native.py,
    # tests/test_dp_device.py).
    engine: str = "auto"
    # --timings: per-phase wall-clock report to stderr (extension)
    timings_flag: bool = False
    # --checkpoint_dir: guide-tree phase checkpoint/resume (extension)
    checkpoint_dir: str = ""

    def with_codon_rescaling(
        self,
        indel_set: bool = False,
        edgehl_set: bool = False,
        maxdist_set: bool = False,
        cutdist_set: bool = False,
    ) -> "Options":
        """Scale default parameters for codon distances (main.cpp:225-241)."""
        if not self.codon_flag:
            return self
        updates = {}
        if not indel_set:
            updates["indel_rate"] = self.indel_rate / 2.6
        if not edgehl_set:
            updates["edge_halflife"] = self.edge_halflife * 2.6
        if not maxdist_set:
            updates["max_dist"] = 5.0
        if not cutdist_set:
            updates["cutoff_dist"] = 5.0
        return dataclasses.replace(self, **updates)

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)


DEFAULT_OPTIONS = Options()
