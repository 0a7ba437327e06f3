#!/bin/bash
# The reference's full training recipe on the fixture corpus with the
# port's CLIs: train_v -> pretrain_g -> adversarial train -> eval_quality
# (V first, then the G pretrain; train picks both up by filename).
#
#   catgen_torch/tools/longrun.sh runs/longrun 400        # on the card
#   DEVICE=cpu FIXTURE=16 catgen_torch/tools/longrun.sh /tmp/lr 1
set -x
DIR=${1:-runs/longrun}
EPOCHS=${2:-400}
DEVICE=${DEVICE:-cuda}
cd "$(dirname "$0")/../.."
mkdir -p "$DIR"
python -m catgen_torch.cli.train_v    --fixture "${FIXTURE:-256}" --epochs "${V_EPOCHS:-30}" \
    --save "$DIR" --device "$DEVICE" || exit 1
python -m catgen_torch.cli.pretrain_g --fixture "${FIXTURE:-256}" --epochs "${PRETRAIN_EPOCHS:-10}" \
    --save "$DIR" --device "$DEVICE" || exit 1
python -m catgen_torch.cli.train      --fixture "${FIXTURE:-256}" --epochs "$EPOCHS" --saveFreq 30 \
    --visFreq "${VISFREQ:-10}" --augment --save "$DIR" --device "$DEVICE" || exit 1
python -m catgen_torch.cli.eval_quality --save "$DIR" --device "$DEVICE" || exit 1
echo LONGRUN_DONE
