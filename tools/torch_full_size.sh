#!/usr/bin/env bash
# Every measurement script of the port, and its benchmark bench_torch.py, at
# full size on one GPU, one after the other; each tool's JSON lines go to <out>/<name>.jsonl, its stderr to
# <out>/<name>.err, and seconds and exit codes to <out>/times.txt.
#
#     bash tools/torch_full_size.sh [out_dir] [scale_run_reads]
#
# Run from the repository root. The scale run comes last (it is the longest
# and the only one that needs gigabytes of disk); its read count defaults
# to 8,000,000 (PARASUITE_SCALE_READS=50000000 is BASELINE config 5).
O=${1:-torch_full_out}
SCALE_READS=${2:-8000000}
mkdir -p "$O"
run() {
    name=$1; shift
    t0=$SECONDS
    "$@" > "$O/$name.jsonl" 2> "$O/$name.err"
    echo "$name rc=$? $((SECONDS - t0)) s" >> "$O/times.txt"
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$O/gpu.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' >> "$O/gpu.txt"
run profile_plain python tools/torch_profile_e2e.py 1048576
run profile_combined python tools/torch_profile_e2e.py 262144 --combined
run sweep_lengths python tools/torch_sweep_lengths.py
run sweep_seeds python tools/torch_sweep_seeds.py
run sweep_twopass python tools/torch_sweep_twopass.py
run rescue_k10 python tools/torch_bench_rescue.py
PARASUITE_RESCUE_K=11 run rescue_k11 python tools/torch_bench_rescue.py
run combined python tools/torch_bench_combined.py
run genome python tools/torch_bench_genome.py
PARASUITE_GENOME_PART=b PARASUITE_GENOME_K=13 PARASUITE_GENOME_MAXOCC=64 \
    run genome_maxocc64 python tools/torch_bench_genome.py
run bench_torch python bench_torch.py
run bench_distributed python tools/torch_bench_distributed.py 131072 --rounds 3
run bench_shards_scale python tools/torch_bench_shards_scale.py
PARASUITE_SCALE_READS=$SCALE_READS run scale python tools/torch_scale_run.py
cat "$O/times.txt"
