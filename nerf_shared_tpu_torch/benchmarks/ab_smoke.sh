#!/usr/bin/env bash
# Parent / change A/B of chip_smoke.py on one card: runs the same phases
# in two unpacked trees in turns (parent, change, change, parent), writes
# each run's whole output to OUT/ab_<n>_<tree>.txt and prints each run's
# exit code and its summary lines (kernel times of phases 2, 5 and 8, step
# and frame ms, profiled device shares). The change tree's chip_smoke.py
# drives both trees (it is copied into the parent tree first), so both run
# the same phases and measurements over their own kernels and wrappers;
# the parent's runs get --parent-tree, so phase 1 does not require the
# tensor-core kernels the parent predates. Exits non-zero if any run
# failed.
#
#   mkdir -p build/parent build/change
#   git archive <parent commit> | tar -x -C build/parent
#   git archive $(git write-tree) | tar -x -C build/change
#   bash nerf_shared_tpu_torch/benchmarks/ab_smoke.sh build/parent build/change \
#       build/ab --phases 2,3,4,7 --profile
set -u
if [ $# -lt 3 ]; then
  echo "usage: ab_smoke.sh PARENT_DIR CHANGE_DIR OUT_DIR [chip_smoke.py arguments]" >&2
  exit 2
fi
parent=$1 change=$2 out=$3
shift 3
mkdir -p "$out"
out=$(cd "$out" && pwd)
cp "$change/chip_smoke.py" "$parent/chip_smoke.py" || exit 1
failed=0
n=0
for which in parent change change parent; do
  n=$((n + 1))
  dir=$parent extra=--parent-tree
  [ "$which" = change ] && dir=$change extra=
  log="$out/ab_${n}_${which}.txt"
  (cd "$dir" && python3 chip_smoke.py "$@" $extra) > "$log" 2>&1
  rc=$?
  [ $rc -ne 0 ] && failed=1
  echo "== run $n: $which ($dir), rc=$rc"
  grep -E "^B[1-5] |^P1 / P2 |ms per step|^triplane: |frame over HTTP|^served 3 frames|^fused-composite frame|ms per frame \(|^profile |of device time|nstt::|HGMMA|^grid build|^phase 7 times|^train step" "$log"
done
exit $failed
