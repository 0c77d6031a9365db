#!/usr/bin/env bash
# Multi-rank training on the four cards of one host (torchrun, NCCL):
#
#   1. gemma-2b's smoke config on one card, 3 steps;
#   2. the same on four cards ("on 4 devices"; its "done:" line, the
#      losses to 3 decimals, must be the first run's);
#   3. gemma-2b at full width on four cards, 12 steps at 8 x 256: the
#      runner logs step 10 with its time and saves a checkpoint there
#      (rank 0 writes each leaf in turn).
#
# Each run's whole output goes to OUT_DIR/four_cards/<run>.log and its
# tail and wall time to stdout.  The first run that fails ends the script
# with its exit code.
#
#   bash tools/train_four_cards.sh OUT_DIR
set -euo pipefail
out=$(realpath -m "${1:?usage: bash tools/train_four_cards.sh OUT_DIR}")/four_cards
cd "$(dirname "$0")/.."
mkdir -p "$out"
ckpt=$(mktemp -d)
trap 'rm -rf "$ckpt"' EXIT
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

run() {
    local name=$1
    shift
    local t0=$SECONDS rc=0
    echo "== $name: $*"
    "$@" > "$out/$name.log" 2>&1 || rc=$?
    grep -v "redistributing\|^USDT\|socket.cpp" "$out/$name.log" | tail -12
    echo "== $name: exit $rc, wall $((SECONDS - t0)) s"
    if [ "$rc" -ne 0 ]; then
        exit "$rc"
    fi
}

smoke=(-m repro_torch.launch.train --arch gemma-2b --smoke --steps 3
       --batch 8 --seq 64)
run smoke_one env CUDA_VISIBLE_DEVICES=0 timeout 180 python "${smoke[@]}" \
    --ckpt "$ckpt/one"
run smoke_four timeout 240 torchrun --standalone --nproc-per-node 4 \
    "${smoke[@]}" --ckpt "$ckpt/four"
one=$(grep "^done:" "$out/smoke_one.log" || true)
four=$(grep "^done:" "$out/smoke_four.log" || true)
if [ -z "$one" ] || [ "$one" != "$four" ]; then
    echo "four cards' last line is not one card's: '$four' vs '$one'"
    exit 1
fi
run full_four timeout 600 torchrun --standalone --nproc-per-node 4 \
    -m repro_torch.launch.train --arch gemma-2b --steps 12 --batch 8 \
    --seq 256 --ckpt "$ckpt/full"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
