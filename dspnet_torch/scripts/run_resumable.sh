#!/usr/bin/env bash
# Auto-resuming training wrapper on the port (counterpart of
# scripts/run_resumable.sh): restarts multi_train with --resume 0 (restore the
# latest checkpoint, or start fresh on an empty model dir) until it exits
# cleanly; each death costs at most the epochs since the last
# --checkpoint-every save.
#
# Usage: dspnet_torch/scripts/run_resumable.sh <multi_train args...>
#   Do not pass --resume (this script owns it; rejected below).
#   MAX_RETRIES=20 (env) bounds restarts; the budget resets whenever an
#   attempt saved a new checkpoint (real progress), so a run that dies before
#   its first save cannot loop forever. WATCHDOG_S (1800): a trainer that
#   neither exits nor writes under the model dir for that long is killed and
#   retried. PYTHON (python3).
set -u
max=${MAX_RETRIES:-20}
tries=0
ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
PY=${PYTHON:-python3}

model_dir="model"
prev=""
for a in "$@"; do
  if [ "$prev" = "--model-dir" ]; then model_dir="$a"; fi
  if [[ "$a" == --model-dir=* ]]; then model_dir="${a#--model-dir=}"; fi
  if [ "$a" = "--resume" ] || [[ "$a" == --resume=* ]]; then
    echo "run_resumable: do not pass --resume; this script manages it" >&2
    exit 2
  fi
  prev="$a"
done

progress_mtime() {
  # newest mtime in the model dir: checkpoint saves bump it, so set
  # WATCHDOG_S comfortably above the checkpoint-every interval
  find "$model_dir" -type f -printf '%T@\n' 2>/dev/null | sort -rn | head -1
}

while true; do
  stamp=$(mktemp)
  "$PY" -m dspnet_torch.cli.multi_train "$@" --resume 0 &
  train_pid=$!
  wd=${WATCHDOG_S:-1800}
  start_ts=$(date +%s)
  while kill -0 "$train_pid" 2>/dev/null; do
    sleep "${POLL_S:-30}"
    last=$(progress_mtime)
    now=$(date +%s)
    ref=${last%%.*}
    [ -z "$ref" ] && ref=$start_ts
    [ "$ref" -lt "$start_ts" ] && ref=$start_ts
    if [ $((now - ref)) -gt "$wd" ]; then
      echo "run_resumable: no progress for ${wd}s; killing trainer $train_pid" >&2
      kill -9 "$train_pid" 2>/dev/null
      break
    fi
  done
  wait "$train_pid"
  rc=$?
  [ "$rc" -eq 0 ] && { rm -f "$stamp"; exit 0; }
  if [ "$rc" -eq 3 ]; then
    # exit 3 = TrainingDiverged (non-finite loss): a resume replays the same
    # seeded epoch and diverges again, so do not retry
    echo "run_resumable: training diverged (exit 3); not retrying" >&2
    rm -f "$stamp"; exit 3
  fi
  progressed=$(find "$model_dir" -type f -newer "$stamp" 2>/dev/null | head -1)
  rm -f "$stamp"
  if [ -n "$progressed" ]; then tries=0; else tries=$((tries + 1)); fi
  if [ "$tries" -ge "$max" ]; then
    echo "run_resumable: giving up after $max attempts without a new checkpoint" >&2
    exit 1
  fi
  echo "run_resumable: train exited $rc; retry $tries/$max in ${RETRY_S:-30}s" >&2
  sleep "${RETRY_S:-30}"
done
