#!/usr/bin/env bash
# The sharded train step of smollm-135m on four ranks, one mesh after the
# other, each run twice in the order given (default: 4,1 1,4 2,2 1,4 4,1):
#
#     tools/tp_step_meshes.sh                       # four cards, NCCL
#     tools/tp_step_meshes.sh --smoke --device cpu  # the smoke config on gloo
#
# Extra arguments go to every `repro_torch.launch.train` run. Each run
# prints the trainer's step lines (loss, grad norm, step seconds) under a
# `== mesh d,m` header, its full log goes to chiprun_out/tp_<d>,<m>.<i>.log,
# and the script exits non-zero if any run failed.
set -u
cd "$(dirname "$0")/.."
mkdir -p chiprun_out
MESHES=${MESHES:-"4,1 1,4 2,2 1,4 4,1"}
port=29561
failed=0
i=0
for m in $MESHES; do
  port=$((port + 1))
  i=$((i + 1))
  log="chiprun_out/tp_$m.$i.log"
  echo "== mesh $m"
  PYTHONPATH=src timeout 600 torchrun --nproc-per-node 4 --master-addr 127.0.0.1 \
    --master-port "$port" -m repro_torch.launch.train --arch smollm-135m --batch 8 \
    --seq 2048 --mesh-shape "$m" --steps 8 "$@" > "$log" 2>&1
  rc=$?
  echo "rc=$rc"
  grep -E "^\[trainer\] step|^\[train\]" "$log" | sort -u
  if [ "$rc" -ne 0 ]; then
    failed=1
    tail -n 20 "$log"
  fi
done
exit "$failed"
