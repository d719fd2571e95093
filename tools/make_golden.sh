#!/bin/bash
# Run the reference oracle binary on the fixtures to produce the golden
# corpus.
set -e
cd "$(dirname "$0")/.."
REF=/root/reference/bin/ProGraphMSA_64
G=fixtures/golden
mkdir -p $G

run() {
  name=$1; shift
  echo "== $name: $REF $* =="
  start=$(date +%s.%N)
  $REF "$@" > /dev/null 2> $G/$name.stderr || { echo "FAILED: $name"; return 0; }
  end=$(date +%s.%N)
  echo "$name $(awk "BEGIN{print $end - $start}")" >> $G/timings.txt
}

rm -f $G/timings.txt

# config 1: default WAG, 2 iterations, FASTA out, small family
run c1_fam20 -o $G/c1_fam20.fasta --fasta fixtures/fam20.fasta
run c1_fam6 -o $G/c1_fam6.fasta --fasta fixtures/fam6.fasta
run c1_fam3 -o $G/c1_fam3.fasta --fasta fixtures/fam3.fasta

# config 1b: stockholm output (default) incl tree
run c1_fam6_sto -o $G/c1_fam6.sto fixtures/fam6.fasta

# tree-only outputs (guide-tree parity on their own)
run tree_fam20 -o $G/tree_fam20.nwk -T fixtures/fam20.fasta
run tree_fam6 -o $G/tree_fam6.nwk -T fixtures/fam6.fasta
run tree0_fam20 -o $G/tree0_fam20.nwk -T -i 0 fixtures/fam20.fasta
run tree0_fam6 -o $G/tree0_fam6.nwk -T -i 0 fixtures/fam6.fasta
run tree0_fam100 -o $G/tree0_fam100.nwk -T -i 0 fixtures/fam100.fasta

# single-iteration alignment (no tree re-estimation): isolates DP parity
run i0_fam6 -o $G/i0_fam6.fasta --fasta -i 0 fixtures/fam6.fasta
run i0_fam20 -o $G/i0_fam20.fasta --fasta -i 0 fixtures/fam20.fasta

# fixed-tree alignments (tie-free DP/merge/output parity; -t implies -i 0)
run t_fam6 -o $G/t_fam6.fasta --fasta -t $G/tree0_fam6.nwk fixtures/fam6.fasta
run t_fam20 -o $G/t_fam20.fasta --fasta -t $G/tree0_fam20.nwk fixtures/fam20.fasta
run t_fam100 -o $G/t_fam100.fasta --fasta -t $G/tree0_fam100.nwk fixtures/fam100.fasta
run t_fam6_anc -o $G/t_fam6_anc.sto --ancestral_seqs -t $G/tree0_fam6.nwk fixtures/fam6.fasta
run t_fam6_E -o $G/t_fam6_E.fasta --fasta -E -1 -t $G/tree0_fam6.nwk fixtures/fam6.fasta
run t_fam20_mld -o $G/t_fam20_mld.fasta --fasta --mldist -t $G/tree0_fam20.nwk fixtures/fam20.fasta
run t_fam20_i1 -o $G/t_fam20_i1.fasta --fasta -i 1 -t $G/tree0_fam20.nwk fixtures/fam20.fasta
run t_fam20_prof -o $G/t_fam20_prof.fasta --fasta --profile_out $G/t_fam20.profile -t $G/tree0_fam20.nwk fixtures/fam20.fasta

# config 2: ML distances + NW initial distance tree, 100 seqs
run c2_fam100 -o $G/c2_fam100.fasta --fasta --mldist --nwdist fixtures/fam100.fasta
run c2_fam20 -o $G/c2_fam20.fasta --fasta --mldist --nwdist fixtures/fam20.fasta
run mld_fam20 -o $G/mld_fam20.fasta --fasta --mldist fixtures/fam20.fasta

# config 3: codon with default ECM.  NOTE: the reference binary's DNA mode
# segfaults on any input containing G or T (DNA::value() indexes the AA
# table, Alphabet.cpp:204-206, causing OOB writes) — no DNA golden possible.
run c3_codon -o $G/c3_codon.fasta --fasta --codon fixtures/orf10.fasta
run c3_codon_i0 -o $G/c3_codon_i0.fasta --fasta --codon -i 0 fixtures/orf10.fasta

# config 4 (partial; K4000.lib missing upstream): +F and ancestral/stockholm
run c4_aafreqs -o $G/c4_aafreqs.sto -F --ancestral_seqs fixtures/fam6.fasta
run c4_darwin -o $G/c4_darwin.fasta --fasta -w --mldist fixtures/fam20.fasta

echo "golden corpus written"
