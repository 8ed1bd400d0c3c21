#!/bin/bash
#
# Infer a substitution scores file for a pair of ENCODE region fastas
# (reference tools/create_scores_file.sh): run scoring inference in
# double-score mode, then fill in derived parameters.
#
# usage: create_scores_file.sh path_to_encode_directories comparison_species

ENCODE="$1"
REGION="ENm010"
REFSPECIES="human"
SECSPECIES=$2

THISDIR=$(dirname "$0")

python -m lastz_tpu_torch.cli --scoretype=double \
    --inferonly="${THISDIR}/create_scores_file.control" \
    "${ENCODE}/${REGION}/${REFSPECIES}.${REGION}.fa" \
    "${ENCODE}/${REGION}/${SECSPECIES}.${REGION}.fa" \
  | python -m lastz_tpu_torch.tools.expand_scores_file --overridegaps
