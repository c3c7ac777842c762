#!/usr/bin/env bash
# Runs chip_smoke.py from an unpacked `git archive` of the tree, which holds
# only what a checkout of the commit holds (the kernels are built there from
# the checkout's sources), then chip_smoke.py alone in an empty directory,
# where it must exit non-zero and print nothing on standard output. Needs
# one NVIDIA card. From the root of the repository:
#
#   git add -A && rm -rf build/archive && mkdir -p build/archive &&
#     git archive "$(git write-tree)" | tar -x -C build/archive
#   bash build/archive/mfas_tpu_torch/scripts/archive_smoke.sh [LOG]
#
# LOG (default build/archive_smoke.log, relative to the directory it is
# started from) receives the archive run's whole output; its last lines
# are printed. Exits 0 when both runs behave.
set -u
root=$(cd "$(dirname "$0")/../.." && pwd)
log=${1:-build/archive_smoke.log}
mkdir -p "$(dirname "$log")"
t0=$(date +%s)
(cd "$root" && python3 chip_smoke.py) > "$log" 2>&1
rc=$?
echo "archive chip_smoke rc=$rc in $(( $(date +%s) - t0 )) s"
tail -n 6 "$log"
alone=$(mktemp -d)
cp "$root/chip_smoke.py" "$alone/"
out=$(cd "$alone" && python3 chip_smoke.py 2> "$alone/stderr")
arc=$?
echo "alone rc=$arc stdout_bytes=${#out}"
tail -n 2 "$alone/stderr"
rm -rf "$alone"
[ "$rc" -eq 0 ] && [ "$arc" -ne 0 ] && [ -z "$out" ]
