from .encoding import (
    NUC_TO_BITS,
    UPPER_NUC_TO_BITS,
    NUC_TO_COMPLEMENT,
    BITS_TO_NUC,
    reverse_complement,
)
from .scoring import (
    ScoreSet,
    HOXD70,
    HOXD70_OPEN,
    HOXD70_EXTEND,
    VERY_BAD_SCORE,
    WORST_POSSIBLE_SCORE,
    NEG_INFINITY_SCORE,
    new_dna_score_set,
    masked_score_set,
    entropy,
)
from .seeds import Seed, parse_seed, SEED_12OF19, SEED_14OF22
