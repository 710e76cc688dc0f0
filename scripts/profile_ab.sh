#!/bin/sh
# Alternating pairs of two checkouts through
# scripts/profile_port.py --kernels --no-checks, each run its own process,
# on the card of the machine it runs on:
#
#     sh scripts/profile_ab.sh PARENT_DIR [PAIRS] [CASES] [OUT_DIR]
#
# PARENT_DIR is the other checkout (say, the parent unpacked with
# `git archive` into an ignored directory); this checkout is the change.
# Pair k runs parent then change for even k, change then parent for odd
# k.  Each run's output goes to OUT_DIR/<k>-<parent|change>.txt (default
# build/profile_ab); its last line is profile_port.py's JSON of device
# and wrapper times.  CASES, if given and not empty, is passed on as
# --cases.
set -e
here=$(cd "$(dirname "$0")/.." && pwd)
parent=$(cd "$1" && pwd)
pairs=${2:-10}
cases=${3:+--cases $3}
out=${4:-$here/build/profile_ab}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
k=0
while [ "$k" -lt "$pairs" ]; do
  if [ $((k % 2)) -eq 0 ]; then order="parent change"; else order="change parent"; fi
  for side in $order; do
    if [ "$side" = parent ]; then root=$parent; else root=$here; fi
    if ! python3 "$here/scripts/profile_port.py" --kernels --no-checks \
        $cases --package-root "$root" > "$out/$k-$side.txt" 2>&1; then
      echo "pair $k $side failed"
      tail -30 "$out/$k-$side.txt"
      exit 1
    fi
    echo "pair $k $side done"
  done
  k=$((k + 1))
done
