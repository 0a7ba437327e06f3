#!/bin/bash
# The quality-evidence artifact set of a longrun.sh run directory: the
# epoch-grid trail, the sampler's artifacts, the quality report, the
# final checkpoint without its optimizer states, and V's rating curve.
#
#   catgen_torch/tools/collect_longrun_artifacts.sh runs/longrun artifacts/lr [epochs...]
set -e
RUN=${1:?run dir}
OUT=${2:-artifacts/longrun}
# shift only what was passed: `shift 2` with one argument shifts nothing
shift $(( $# > 2 ? 2 : $# ))
EPOCHS=${@:-"1 10 50 100 150 200 300 400 500 600 700 750"}
DEVICE=${DEVICE:-cuda}
cd "$(dirname "$0")/../.."
mkdir -p "$OUT/epochs" "$OUT/samples"
for e in $EPOCHS; do
    f=$(printf "%s/images/epoch_%06d.png" "$RUN" "$e")
    [ -f "$f" ] && cp "$f" "$OUT/epochs/"
done
python -m catgen_torch.cli.sample --save "$RUN" --runs 1 --neighbours --device "$DEVICE"
cp "$RUN"/samples/run0_best64.png "$RUN"/samples/run0_worst64.png \
   "$RUN"/samples/run0_real64.png "$RUN"/samples/run0_neighbours.png \
   "$OUT/samples/" 2>/dev/null || cp "$RUN"/run0_*.png "$OUT/samples/" 2>/dev/null || true
python -m catgen_torch.cli.eval_quality --save "$RUN" --out "$OUT/quality_report.json" \
    --device "$DEVICE"
python -m catgen_torch.tools.slim_ckpt "$RUN/adversarial.ckpt" "$OUT/adversarial_slim.ckpt"
python - "$RUN" "$OUT" <<'PY'
import json, sys
run, out = sys.argv[1], sys.argv[2]
by_epoch = {}
with open(f"{run}/train_metrics.jsonl") as f:
    for line in f:
        r = json.loads(line)
        if r.get("event") == "viz":
            by_epoch[r["epoch"]] = {k: r[k] for k in
                                    ("epoch", "v_rating_all",
                                     "d_probe_pattern", "d_probe_real")
                                    if k in r}
pts = [by_epoch[e] for e in sorted(by_epoch)]   # a resumed run repeats
with open(f"{out}/v_curve.json", "w") as f:
    json.dump(pts, f, indent=1)
print(f"[collect] {len(pts)} v-curve points -> {out}/v_curve.json")
PY
echo COLLECT_DONE
