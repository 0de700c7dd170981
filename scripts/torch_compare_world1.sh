#!/bin/bash
# The one-process fluid and advection paths of the port's chip_smoke.py
# (main split path, merged2 path, advection path) on each of the given
# trees in turn, in one run: compares two commits on one card.
#
#   bash scripts/torch_compare_world1.sh LOG TREE_A TREE_B ...
#
# Each TREE is a directory holding a checkout of the repo (for example
# `git archive` of a commit unpacked under a directory .gitignore lists),
# relative to the repo root or absolute. Every line is prefixed with its
# tree; the whole log goes to LOG (relative to the repo root), its tail to
# standard output.
set -o pipefail
cd "$(dirname "$0")/.."
log=$1
shift
mkdir -p "$(dirname "$log")"
for tree in "$@"; do
  (cd "$tree" && python3 -c "
import chip_smoke as cs
cs.phase_device()
from insr_pde_tpu_torch.ops.precision import set_full_precision
set_full_precision()
cs.phase_build()
cs.phase_main_path(); cs.phase_merged2_path(); cs.phase_advection_path()
print('[tree done]')
") 2>&1 | grep -v "^\[build\]" | sed "s|^|[$tree] |"
done > "$log"
tail -c 20000 "$log"
