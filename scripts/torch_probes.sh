#!/usr/bin/env bash
# The port's probes at the JAX repo's published sizes, on one CUDA card:
#   bash scripts/torch_probes.sh [OUT_DIR] [HASHGRID_T]
# Each tool's JSON lines go to OUT_DIR/<tool>.jsonl (default
# results/probes). The hash grid's advect iteration is host-paced (~25
# ms), so its run is cut to HASHGRID_T steps (default 2) of the published
# 10,000 iterations; SIREN runs the published T = 20.
set -euo pipefail
out=${1:-results/probes}
hash_t=${2:-2}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/device.txt"
run() {
    local name=$1; shift
    local tic=$(date +%s)
    python -m "insr_pde_tpu_torch.$name" "$@" | tee -a "$out/$name.jsonl"
    echo "[probes] $name $* : $(( $(date +%s) - tic )) s" | tee -a "$out/times.txt"
}
run overhead_probe --phase pressure
run overhead_probe --phase advect
run width_probe --widths 32,64,128,256
run coherence_probe
run vortex_train_probe --train_iters 4000 --lr 0.1 --lr_min 1e-3 --compare_matrix
run hashgrid_probe -T 20 --iters 10000 --networks siren
run plateau_probe --candidates ref,f5p300
run hashgrid_probe -T "$hash_t" --iters 10000 --networks hashgrid
